"""PPO on PyTorch: rollout workers on the host + a learner on the card.

Port of ``ray_tpu/rllib/ppo.py``. The pieces keep JAX's names:

- the RLModule is ``PolicyValueMLP`` (``init_module``/``forward_module``,
  ``:30,48``): its weights are plain ``Parameter``s in JAX's
  ``[fan_in, fan_out]`` layout (``x @ w + b``), so a JAX parameter tree
  maps onto it name for name (``convert.policy_value_from_numpy``) and a
  square 64x64 layer cannot be read transposed;
- the rollout host code is numpy, copied verbatim (``_RolloutWorker``,
  ``_np_forward``, ``_sample_actions``, ``_gae``): the workers read the
  parameters as numpy, copied from the card once an iteration
  (``PolicyValueMLP.numpy_tree``);
- the loss is ``ppo_loss``, the counterpart of ``_ppo_grads`` (``:360``);
  the learner (``rllib.learner_group.Learner``) differentiates it and
  steps ``adam(lr)``, optax's ``adam`` as the port's ``AdamW``.

The rollout workers are objects of this process, stepped one after
another with JAX's seeds (``seed + 1000*(i+1)``); each worker's batch
depends only on its seed and the parameters, so the batches equal those
of JAX's rollout actors. Entry points run on the card
(``PPOConfig.device``, default "cuda") unless the config asks for the CPU.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.train.optim import AdamW

# ---------------------------------------------------------------------------
# RLModule: an MLP policy + value heads
# ---------------------------------------------------------------------------

LAYERS = ("torso1", "torso2", "pi", "vf")


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[fan_in, fan_out]``, as JAX's
    ``dense`` (``nn.Linear`` would store ``[out, in]``)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class PolicyValueMLP(nn.Module):
    """``forward_module`` (``ray_tpu/rllib/ppo.py:48``): two tanh layers,
    then the logits and the squeezed value. Built from a tree
    ``{layer: {"w", "b"}}`` of tensors, one ``Dense`` a layer of
    ``LAYERS``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in LAYERS:
            setattr(self, name, Dense(tree[name]["w"], tree[name]["b"]))

    def forward(self, obs: torch.Tensor):
        h = torch.tanh(self.torso1(obs))
        h = torch.tanh(self.torso2(h))
        return self.pi(h), self.vf(h).squeeze(-1)

    @torch.no_grad()
    def numpy_tree(self) -> dict:
        """The parameters as JAX's numpy tree (what ``_params_np``
        gives), copied to the host in one transfer."""
        params = list(self.parameters())
        flat = torch.cat([p.reshape(-1) for p in params]).cpu().numpy()
        leaves = iter(np.split(flat, np.cumsum([p.numel()
                                                for p in params])[:-1]))
        return {name: {leaf: next(leaves).reshape(p.shape)
                       for leaf, p in getattr(self, name).named_parameters()}
                for name in LAYERS}


def init_module(seed: int, obs_dim: int, n_actions: int, hidden: int = 64,
                *, device="cuda") -> PolicyValueMLP:
    """``init_module`` (``ray_tpu/rllib/ppo.py:30``): He-normal ``w``
    (a standard normal times ``(2/fan_in)**0.5``) and zero ``b``, drawn
    in layer order from a CPU generator seeded with ``seed`` and then
    moved, so a CPU run and a card run start from the same numbers."""
    gen = torch.Generator().manual_seed(seed)

    def dense(fan_in, fan_out):
        return {"w": torch.randn(fan_in, fan_out, generator=gen)
                * (2.0 / fan_in) ** 0.5,
                "b": torch.zeros(fan_out)}

    tree = {"torso1": dense(obs_dim, hidden), "torso2": dense(hidden, hidden),
            "pi": dense(hidden, n_actions), "vf": dense(hidden, 1)}
    return PolicyValueMLP(tree).to(resolve_device(device))


def _constant(lr: float, count: int) -> float:
    return lr


def adam(lr: float) -> AdamW:
    """``optax.adam(lr)``: the port's ``AdamW`` with a constant schedule,
    no weight decay and no clipping (a picklable schedule, so learner
    ranks can take it)."""
    return AdamW(partial(_constant, lr), max_grad_norm=float("inf"),
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)


def logp_of(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """The log-probabilities of ``actions`` (``take_along_axis`` on the
    last axis)."""
    return logp_all.gather(-1, actions.long()[..., None]).squeeze(-1)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


# ---------------------------------------------------------------------------
# Rollout workers (host code, copied from the JAX package)
# ---------------------------------------------------------------------------

class _RolloutWorker:
    """VECTORIZED env runner (reference: ``EnvRunner`` over vectorized
    envs, rllib/env/env_runner.py:9): ``num_envs`` environments step in
    lockstep with ONE batched policy forward per step — the per-step
    numpy matmul amortizes over the env batch instead of running once
    per environment (the round-3 one-env-per-forward weakness)."""

    def __init__(self, env_name, seed: int, num_envs: int = 1):
        self.envs = [make_env(env_name, seed=seed + i)
                     for i in range(num_envs)]
        self.rng = np.random.default_rng(seed)
        self.num_envs = num_envs

    def sample(self, params_np: dict, num_steps: int, gamma: float,
               lam: float):
        """Collect num_steps transitions PER ENV; returns a flat numpy
        batch (n_envs * num_steps rows) with GAE advantages computed
        env-side (cheap, host-bound anyway)."""
        ne = self.num_envs
        obs = np.stack([e.reset() for e in self.envs])      # [E, obs]
        obs_l, act_l, logp_l, rew_l, val_l, done_l = ([] for _ in range(6))
        episode_returns = []
        ep_ret = np.zeros(ne)
        for _ in range(num_steps):
            logits, values = _np_forward(params_np, obs)    # [E, A], [E]
            probs = _softmax_rows(logits)
            actions = _sample_actions(self.rng, probs)
            obs_l.append(obs.copy())
            act_l.append(actions)
            logp_l.append(np.log(
                probs[np.arange(ne), actions] + 1e-8))
            val_l.append(values)
            step_rew = np.zeros(ne)
            step_done = np.zeros(ne, bool)
            next_obs = obs.copy()
            for i, env in enumerate(self.envs):
                o, r, d, _ = env.step(int(actions[i]))
                step_rew[i] = r
                step_done[i] = d
                ep_ret[i] += r
                if d:
                    episode_returns.append(float(ep_ret[i]))
                    ep_ret[i] = 0.0
                    o = env.reset()
                next_obs[i] = o
            rew_l.append(step_rew)
            done_l.append(step_done.astype(np.float32))
            obs = next_obs
        _, last_vals = _np_forward(params_np, obs)          # [E]
        # per-env GAE over the time axis
        rews = np.stack(rew_l)                              # [T, E]
        vals = np.stack(val_l)
        dones = np.stack(done_l)
        adv = np.zeros_like(rews)
        ret = np.zeros_like(rews)
        for i in range(ne):
            a, r = _gae(rews[:, i], vals[:, i], dones[:, i],
                        float(last_vals[i]), gamma, lam)
            adv[:, i] = a
            ret[:, i] = r
        return {
            "obs": np.stack(obs_l).reshape(-1, obs.shape[-1]).astype(
                np.float32),
            "actions": np.stack(act_l).reshape(-1).astype(np.int32),
            "logp": np.stack(logp_l).reshape(-1).astype(np.float32),
            "advantages": adv.reshape(-1).astype(np.float32),
            "returns": ret.reshape(-1).astype(np.float32),
            "episode_returns": episode_returns,
        }


def _np_forward(params, obs):
    h = np.tanh(obs @ params["torso1"]["w"] + params["torso1"]["b"])
    h = np.tanh(h @ params["torso2"]["w"] + params["torso2"]["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"]).squeeze(-1)
    return logits, value


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _softmax_rows(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _sample_actions(rng, probs) -> np.ndarray:
    """Vectorized categorical sampling (inverse CDF per row). Raises on
    non-finite probabilities like ``Generator.choice`` would — silent
    action-0 fallback would mask a diverged policy."""
    if not np.all(np.isfinite(probs)):
        raise ValueError("policy produced non-finite action probabilities "
                         "(diverged parameters?)")
    u = rng.random((probs.shape[0], 1))
    actions = (probs.cumsum(axis=1) < u).sum(axis=1)
    return np.minimum(actions, probs.shape[1] - 1)


def _gae(rewards, values, dones, last_value, gamma, lam):
    n = len(rewards)
    adv = np.zeros(n)
    last_gae = 0.0
    next_value = last_value
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    return adv, adv + values


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def ppo_loss(module: PolicyValueMLP, batch: dict, *, clip_eps: float,
             entropy_coeff: float, vf_coeff: float):
    """The loss of ``_ppo_grads`` (``ray_tpu/rllib/ppo.py:360``): the
    clipped surrogate, the value loss and the entropy bonus, on a batch of
    tensors. Returns (total, stats)."""
    logits, values = module(batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_of(logp_all, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    vf_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = entropy_of(logp_all)
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


# ---------------------------------------------------------------------------
# Config + Algorithm
# ---------------------------------------------------------------------------

@dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    # envs stepped in lockstep per worker (one batched forward per step)
    num_envs_per_worker: int = 1
    rollout_fragment_length: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    num_sgd_iter: int = 4
    minibatch_size: int = 128
    hidden: int = 64
    seed: int = 0
    # multi-learner plane (rllib.learner_group): 0 = one learner in this
    # process; >=1 = a LearnerGroup of that many data-parallel learners
    # ("mesh": dp places of one mesh; "actors": rank processes)
    num_learners: int = 0
    learner_mode: str = "mesh"
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "PPOConfig":
        return replace(self, env=env)

    def rollouts(self, *, num_rollout_workers=None,
                 rollout_fragment_length=None) -> "PPOConfig":
        cfg = self
        if num_rollout_workers is not None:
            cfg = replace(cfg, num_rollout_workers=num_rollout_workers)
        if rollout_fragment_length is not None:
            cfg = replace(cfg,
                          rollout_fragment_length=rollout_fragment_length)
        return cfg

    def training(self, **kw) -> "PPOConfig":
        return replace(self, **kw)

    def build(self) -> "PPO":
        return PPO(self)


def _episode_mean(episode_returns: list) -> float:
    return float(np.mean(episode_returns)) if episode_returns else 0.0


class PPO:
    """The algorithm (reference: ``Algorithm.step:815`` →
    ``training_step:1402`` = sample from rollout workers + learner
    update). ``train()`` also reports its seconds split into sampling and
    learning (``sample_time_s``, ``learn_time_s``)."""

    def __init__(self, config: PPOConfig):
        from ray_tpu_torch.rllib.learner_group import build_learner

        self.config = config
        env = make_env(config.env, seed=config.seed)
        self.obs_dim = env.obs_dim
        self.n_actions = env.n_actions
        self.iteration = 0
        self.workers = [
            _RolloutWorker(config.env, config.seed + 1000 * (i + 1),
                           config.num_envs_per_worker)
            for i in range(config.num_rollout_workers)
        ]
        self.learner = build_learner(
            init_fn=partial(init_module, obs_dim=self.obs_dim,
                            n_actions=self.n_actions, hidden=config.hidden),
            loss_fn=partial(ppo_loss, clip_eps=config.clip_eps,
                            entropy_coeff=config.entropy_coeff,
                            vf_coeff=config.vf_coeff),
            tx=adam(config.lr), num_learners=config.num_learners,
            mode=config.learner_mode, seed=config.seed,
            device=config.device)

    def _params_np(self):
        return self.learner.get_params()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        params_np = self._params_np()
        batches = [w.sample(params_np, cfg.rollout_fragment_length,
                            cfg.gamma, cfg.lam) for w in self.workers]
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in ("obs", "actions", "logp", "advantages",
                           "returns")}
        episode_returns = [r for b in batches for r in b["episode_returns"]]
        # advantage normalization (standard PPO practice)
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        t1 = time.perf_counter()

        n = len(batch["obs"])
        rng = np.random.default_rng(cfg.seed + self.iteration)
        losses = []
        for _ in range(cfg.num_sgd_iter):
            perm = rng.permutation(n)
            for start in range(0, n, cfg.minibatch_size):
                idx = perm[start:start + cfg.minibatch_size]
                losses.append(self.learner.update(
                    {k: v[idx] for k, v in batch.items()}))
        self.iteration += 1
        mean = lambda key: float(np.mean([s[key] for s in losses]))  # noqa: E731
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": _episode_mean(episode_returns),
            "num_episodes": len(episode_returns),
            "policy_loss": mean("policy_loss"),
            "vf_loss": mean("vf_loss"),
            "entropy": mean("entropy"),
            "num_env_steps_sampled": n,
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def save(self, path: str):
        """JAX's checkpoint format: a pickle of the numpy parameter tree."""
        with open(path, "wb") as f:
            pickle.dump(self._params_np(), f)

    def restore(self, path: str):
        """Load a pickle of a numpy parameter tree (this port's or the JAX
        package's ``save``) through ``convert.policy_value_from_numpy``."""
        with open(path, "rb") as f:
            self.learner.set_params(pickle.load(f))

    def compute_action(self, obs) -> int:
        logits, _ = _np_forward(self._params_np(), np.asarray(obs)[None])
        return int(np.argmax(logits[0]))

    def stop(self):
        self.learner.stop()
