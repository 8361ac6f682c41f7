"""SAC on PyTorch: continuous control with a squashed-Gaussian actor,
twin Q critics, soft target updates and an auto-tuned entropy
temperature.

Port of ``ray_tpu/rllib/sac.py`` (reference analog:
``rllib/algorithms/sac/``: twin Q networks, target entropy = -|A|, replay
buffer). The networks are JAX's list-of-layers trees, ``[{"w": [fan_in,
fan_out], "b": [fan_out]}, ...]`` of tensors (``x @ w + b``), so a JAX
tree maps onto them leaf for leaf (``convert.mlp_tree_from_numpy``). The
whole update (critics, actor, temperature, then the Polyak targets) is
``_sac_update`` on the learner's device, one Adam over the whole tree,
the 0-d ``log_alpha`` included.

Noise is an input: the update takes its two standard-normal draws as
tensors. ``SAC._noise`` draws them from a CPU generator seeded with
``seed + 1`` (JAX splits ``jax.random.key(seed + 1)``), so a CPU run and
a card run of the port draw the same numbers. The rollout workers are
numpy, copied verbatim, stepped in this process with JAX's seeds.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.dqn import (ReplayBuffer, adam_step,
                                     init_opt_state, to_device)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import adam

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


# ---------------------------------------------------------------------------
# networks (list-of-layers MLPs: the actor outputs (mu, log_std), the
# critics take [obs, action] and output one scalar)
# ---------------------------------------------------------------------------

def _init_mlp(gen: torch.Generator, sizes, device) -> list:
    """``_init_mlp`` (``ray_tpu/rllib/sac.py:30``): ``w`` a standard
    normal times ``fan_in**-0.5`` drawn from the CPU generator ``gen``,
    ``b`` zero; every leaf on ``device``, taking gradients."""
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(n_in, n_out, generator=gen) * (n_in ** -0.5)
        params.append({"w": w.to(device).requires_grad_(),
                       "b": torch.zeros(n_out, device=device,
                                        requires_grad=True)})
    return params


def _mlp(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def init_sac(seed: int, obs_dim: int, action_dim: int, hidden: int = 64,
             *, device="cuda") -> dict:
    """The actor, the two critics (drawn in that order from one CPU
    generator seeded with ``seed``) and ``log_alpha`` 0."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {
        "actor": _init_mlp(gen, (obs_dim, hidden, hidden, 2 * action_dim),
                           dev),
        "q1": _init_mlp(gen, (obs_dim + action_dim, hidden, hidden, 1), dev),
        "q2": _init_mlp(gen, (obs_dim + action_dim, hidden, hidden, 1), dev),
        "log_alpha": torch.zeros((), device=dev, requires_grad=True),
    }


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _stopped(tree):
    """``tree`` with every leaf detached (``jax.lax.stop_gradient``)."""
    if isinstance(tree, dict):
        return {k: _stopped(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stopped(v) for v in tree]
    return tree.detach()


def frozen_tree(tree):
    """A copy of ``tree`` that takes no gradient (target networks)."""
    if isinstance(tree, dict):
        return {k: frozen_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [frozen_tree(v) for v in tree]
    return tree.detach().clone()


def numpy_tree(tree):
    """``tree`` as numpy arrays of the same structure, copied to the host
    in one transfer."""
    flat = leaves(tree)
    host = torch.cat([x.detach().reshape(-1) for x in flat]).cpu().numpy()
    parts = iter(np.split(host, np.cumsum([x.numel() for x in flat])[:-1]))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(parts).reshape(node.shape)

    return build(tree)


@torch.no_grad()
def polyak(targets: dict, params: dict, tau: float) -> None:
    """Each target leaf set to ``(1 - tau) * t + tau * o`` of its online
    leaf, in place."""
    for k in targets:
        for t, o in zip(leaves(targets[k]), leaves(params[k]), strict=True):
            t.copy_((1 - tau) * t + tau * o)


def _actor_dist(actor_params, obs):
    mu, log_std = torch.chunk(_mlp(actor_params, obs), 2, dim=-1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """The squashing tanh of ``_sample_action``, a function of its own so
    that a comparison can give both sides one implementation's values
    (see ``_sample_action``)."""
    return torch.tanh(x)


def _sample_action(actor_params, obs, eps: torch.Tensor):
    """Squashed-Gaussian sample from the standard normal ``eps`` and its
    log-prob (tanh correction). The correction ``log(1 - a**2 + 1e-6)`` is
    JAX's float32 formula, ill-conditioned where ``|pre|`` passes about 5:
    there one ulp of ``a`` moves a row's log-prob by up to 0.4 nats, and
    float32 tanh differs in the last ulp between XLA, the CPU and CUDA."""
    mu, log_std = _actor_dist(actor_params, obs)
    std = torch.exp(log_std)
    pre = mu + std * eps
    a = _tanh(pre)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
        - torch.log(1 - a ** 2 + 1e-6),
        dim=-1,
    )
    return a, logp


def _q(params, obs, act):
    return _mlp(params, torch.cat([obs, act], dim=-1))[..., 0]


def _sac_update(params, target_q, opt_state, batch, noise, *, tx, gamma,
                tau, target_entropy) -> dict:
    """One SAC step (``ray_tpu/rllib/sac.py:96``), in place: critics ->
    actor -> temperature, then Polyak targets. ``noise`` holds the two
    standard-normal draws [2, B, A]: the next state's action (JAX's
    ``k1``) and the batch state's (``k2``). Returns the metrics of the
    parameters before the step, as JAX's."""
    obs, act = batch["obs"], batch["actions"]
    rew, nxt, done = batch["rewards"], batch["next_obs"], batch["dones"]
    eps1, eps2 = noise[0], noise[1]

    # target: r + gamma * (min Q_target(s', a') - alpha * logp(a')), from
    # the actor and alpha before the step
    with torch.no_grad():
        alpha = torch.exp(params["log_alpha"])
        na, nlogp = _sample_action(params["actor"], nxt, eps1)
        tq = torch.minimum(_q(target_q["q1"], nxt, na),
                           _q(target_q["q2"], nxt, na))
        target = rew + gamma * (1.0 - done) * (tq - alpha * nlogp)

    q1 = _q(params["q1"], obs, act)
    q2 = _q(params["q2"], obs, act)
    critic_loss = torch.mean((q1 - target) ** 2) \
        + torch.mean((q2 - target) ** 2)
    a_new, logp = _sample_action(params["actor"], obs, eps2)
    # the critics read through stopped parameters: the actor loss reaches
    # the actor through a_new only
    q_new = torch.minimum(_q(_stopped(params["q1"]), obs, a_new),
                          _q(_stopped(params["q2"]), obs, a_new))
    actor_loss = torch.mean(
        torch.exp(params["log_alpha"].detach()) * logp - q_new)
    alpha_loss = -params["log_alpha"] * torch.mean(
        logp.detach() + target_entropy)
    total = critic_loss + actor_loss + alpha_loss
    metrics = {"critic_loss": critic_loss.detach(),
               "actor_loss": actor_loss.detach(),
               "alpha": torch.exp(params["log_alpha"]).detach(),
               "entropy": -torch.mean(logp).detach()}
    adam_step(tx, opt_state, leaves(params), total)
    polyak(target_q, params, tau)
    return metrics


# ---------------------------------------------------------------------------
# Rollout workers (host code, copied from the JAX package)
# ---------------------------------------------------------------------------

class _ContinuousRolloutWorker:
    """Shared rollout actor for the continuous-control algorithms (SAC,
    TD3/DDPG): env stepping, warmup random actions, episode bookkeeping,
    action scaling. Subclasses supply ``_act`` (the numpy policy)."""

    def __init__(self, env_name, seed: int):
        self.env = make_env(env_name, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.obs = self.env.reset()
        self.ep_ret = 0.0
        self.low = float(getattr(self.env, "action_low", -1.0))
        self.high = float(getattr(self.env, "action_high", 1.0))

    def _act(self, actor_np, obs):
        raise NotImplementedError

    def _mlp_np(self, actor_np, obs):
        x = obs[None]
        for i, layer in enumerate(actor_np):
            x = x @ layer["w"] + layer["b"]
            if i < len(actor_np) - 1:
                x = np.tanh(x)
        return x[0]

    def _scale(self, a):
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)

    def sample(self, actor_np, num_steps: int, random_actions: bool):
        obs_l, next_l, act_l, rew_l, done_l = [], [], [], [], []
        episode_returns = []
        for _ in range(num_steps):
            if random_actions:
                a = self.rng.uniform(-1.0, 1.0,
                                     size=self.env.action_dim)
            else:
                a = self._act(actor_np, self.obs)
            next_obs, reward, done, _ = self.env.step(self._scale(a))
            obs_l.append(self.obs)
            next_l.append(next_obs)
            act_l.append(np.asarray(a, np.float32))
            rew_l.append(reward)
            done_l.append(float(done))
            self.ep_ret += reward
            if done:
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {"obs": np.asarray(obs_l, np.float32),
                "next_obs": np.asarray(next_l, np.float32),
                "actions": np.asarray(act_l, np.float32),
                "rewards": np.asarray(rew_l, np.float32),
                "dones": np.asarray(done_l, np.float32),
                "episode_returns": episode_returns}


class _SACRolloutWorker(_ContinuousRolloutWorker):
    def _act(self, actor_np, obs):
        # numpy mirror of _sample_action
        mu, log_std = np.split(self._mlp_np(actor_np, obs), 2)
        std = np.exp(np.clip(log_std, LOG_STD_MIN, LOG_STD_MAX))
        return np.tanh(mu + std * self.rng.standard_normal(mu.shape))


# ---------------------------------------------------------------------------
# Config + Algorithm
# ---------------------------------------------------------------------------

@dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005              # polyak target rate
    buffer_capacity: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    num_updates_per_iter: int = 32
    target_entropy: float | None = None   # default -action_dim
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "SACConfig":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "SACConfig":
        return replace(self, **kw)

    def training(self, **kw) -> "SACConfig":
        return replace(self, **kw)

    def build(self) -> "SAC":
        return SAC(self)


def sample_continuous(workers, actor_np, cfg, buffer) -> list:
    """One sampling round of the continuous-control workers into
    ``buffer`` (random actions until ``learning_starts``); returns the
    episodes' returns."""
    warmup = buffer.size < cfg.learning_starts
    episode_returns = []
    for w in workers:
        b = w.sample(actor_np, cfg.rollout_fragment_length, warmup)
        episode_returns.extend(b.pop("episode_returns"))
        buffer.add_batch(b)
    return episode_returns


class SAC:
    """``train()`` also reports its seconds split into sampling and
    learning (``sample_time_s``, ``learn_time_s``)."""

    def __init__(self, config: SACConfig):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        if not getattr(env, "continuous", False):
            raise ValueError(f"SAC requires a continuous-action env, "
                             f"got {config.env!r}")
        self.obs_dim = env.obs_dim
        self.action_dim = env.action_dim
        self.action_low = float(getattr(env, "action_low", -1.0))
        self.action_high = float(getattr(env, "action_high", 1.0))
        self.params = init_sac(config.seed, self.obs_dim, self.action_dim,
                               config.hidden, device=self.device)
        self.target_q = frozen_tree({"q1": self.params["q1"],
                                 "q2": self.params["q2"]})
        self.tx = adam(config.lr)
        self.opt_state = init_opt_state(self.tx, leaves(self.params))
        self.buffer = ReplayBuffer(config.buffer_capacity, self.obs_dim,
                                   action_shape=(self.action_dim,),
                                   action_dtype=np.float32,
                                   gamma=config.gamma)
        self.iteration = 0
        self.rng = np.random.default_rng(config.seed)
        self.noise_gen = torch.Generator().manual_seed(config.seed + 1)
        te = (config.target_entropy if config.target_entropy is not None
              else -float(self.action_dim))
        self.workers = [
            _SACRolloutWorker(config.env, config.seed + 1000 * (i + 1))
            for i in range(config.num_rollout_workers)
        ]
        self._update = partial(
            _sac_update, tx=self.tx, gamma=config.gamma, tau=config.tau,
            target_entropy=te)

    def _noise(self, batch_size: int) -> np.ndarray:
        """An update's two standard-normal draws, [2, batch, action_dim]."""
        return torch.randn((2, batch_size, self.action_dim),
                           generator=self.noise_gen).numpy()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        episode_returns = sample_continuous(
            self.workers, numpy_tree(self.params["actor"]), cfg, self.buffer)
        t1 = time.perf_counter()
        metrics = {}
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                mb = to_device(self.buffer.sample(cfg.train_batch_size,
                                                  self.rng), self.device)
                noise = torch.from_numpy(self._noise(
                    cfg.train_batch_size)).to(self.device)
                metrics = self._update(self.params, self.target_q,
                                       self.opt_state, mb, noise)
            metrics = dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist()))
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (float(np.mean(episode_returns))
                                    if episode_returns else float("nan")),
            "episodes_this_iter": len(episode_returns),
            "buffer_size": self.buffer.size,
            **metrics,
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_single_action(self, obs) -> np.ndarray:
        """Deterministic (mean) action for evaluation."""
        with torch.no_grad():
            mu, _ = _actor_dist(self.params["actor"], torch.as_tensor(
                np.asarray(obs, np.float32)[None], device=self.device))
        a = np.tanh(mu.cpu().numpy()[0])
        return self.action_low + (a + 1.0) * 0.5 * (
            self.action_high - self.action_low)

    def stop(self):
        pass
