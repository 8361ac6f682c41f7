"""TD3 (+ DDPG) for continuous control on PyTorch.

Port of ``ray_tpu/rllib/td3.py`` (reference analog:
``rllib/algorithms/td3`` / ``rllib/algorithms/ddpg``). TD3 is a
deterministic-policy actor-critic with three fixes over DDPG: twin
critics (min-Q targets), target-policy smoothing noise and delayed policy
updates. DDPG is the degenerate config (single critic, no smoothing,
delay 1), exposed as :class:`DDPG`.

It shares the list-of-layers networks, the replay buffer and the rollout
worker with SAC (``rllib/sac.py``). ``_td3_update`` runs on the learner's
device and takes the smoothing noise as a standard-normal tensor;
``TD3._noise`` draws it from a CPU generator seeded with ``seed + 1``.
DDPG multiplies it by 0, but the draw is kept, so the streams stay
aligned.
"""

from __future__ import annotations

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
from ray_tpu_torch.rllib.sac import (_ContinuousRolloutWorker, _init_mlp,
                                     _mlp, _q, _stopped, frozen_tree,
                                     leaves, numpy_tree, polyak,
                                     sample_continuous)


def init_td3(seed: int, obs_dim: int, action_dim: int, hidden: int = 64,
             twin_q: bool = True, *, device="cuda") -> dict:
    """The actor and the critics, drawn in that order from one CPU
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "actor": _init_mlp(gen, (obs_dim, hidden, hidden, action_dim), dev),
        "q1": _init_mlp(gen, (obs_dim + action_dim, hidden, hidden, 1), dev),
    }
    if twin_q:
        params["q2"] = _init_mlp(gen, (obs_dim + action_dim, hidden,
                                       hidden, 1), dev)
    return params


def _pi(actor_params, obs):
    return torch.tanh(_mlp(actor_params, obs))


def _td3_update(params, targets, opt_state, batch, noise, do_policy: bool,
                *, tx, gamma, tau, target_noise, noise_clip,
                twin_q) -> dict:
    """One TD3 step (``ray_tpu/rllib/td3.py:50``), in place: the critics
    every call; the actor (and the Polyak targets) only when
    ``do_policy`` (delayed policy updates). ``noise`` is the standard
    normal [B, A] of the target-policy smoothing."""
    obs, act = batch["obs"], batch["actions"]
    rew, nxt, done = batch["rewards"], batch["next_obs"], batch["dones"]

    # target action with clipped smoothing noise (TD3 fix #2)
    with torch.no_grad():
        na = _pi(targets["actor"], nxt)
        na = torch.clamp(na + torch.clamp(target_noise * noise, -noise_clip,
                                          noise_clip), -1.0, 1.0)
        tq = _q(targets["q1"], nxt, na)
        if twin_q:
            tq = torch.minimum(tq, _q(targets["q2"], nxt, na))  # fix #1
        target = rew + gamma * (1.0 - done) * tq

    c_loss = torch.mean((_q(params["q1"], obs, act) - target) ** 2)
    if twin_q:
        c_loss = c_loss + torch.mean((_q(params["q2"], obs, act)
                                      - target) ** 2)
    a_loss = -torch.mean(_q(_stopped(params["q1"]), obs,
                            _pi(params["actor"], obs)))
    actor = leaves(params["actor"])
    # delayed policy updates (fix #3): Adam's moments take the actor's
    # gradient on every call; off the policy steps the APPLIED actor
    # update is undone. Zeroing only the gradient would still move the
    # actor through the moments' nonzero first moment
    held = None if do_policy else [p.detach().clone() for p in actor]
    adam_step(tx, opt_state, leaves(params), c_loss + a_loss)
    if held is not None:
        with torch.no_grad():
            for p, h in zip(actor, held):
                p.copy_(h)
    else:
        # polyak targets move only on policy steps (matches the paper)
        polyak(targets, params, tau)
    return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}


class _TD3RolloutWorker(_ContinuousRolloutWorker):
    """Deterministic policy + Gaussian exploration noise (reference:
    DDPG/TD3 exploration); rollout loop shared with SAC."""

    def __init__(self, env_name, seed: int, expl_noise: float):
        super().__init__(env_name, seed)
        self.expl_noise = expl_noise

    def _act(self, actor_np, obs):
        a = np.tanh(self._mlp_np(actor_np, obs))
        a = a + self.expl_noise * self.rng.standard_normal(a.shape)
        return np.clip(a, -1.0, 1.0)


@dataclass
class TD3Config:
    env: str = "Pendulum-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    buffer_capacity: int = 100_000
    learning_starts: int = 500
    train_batch_size: int = 128
    num_updates_per_iter: int = 32
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    expl_noise: float = 0.1
    twin_q: bool = True
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "TD3Config":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "TD3Config":
        return replace(self, **kw)

    def training(self, **kw) -> "TD3Config":
        return replace(self, **kw)

    def build(self) -> "TD3":
        return TD3(self)


@dataclass
class DDPGConfig(TD3Config):
    """DDPG = TD3 minus its three fixes (reference: ddpg is the base
    TD3 generalizes)."""

    policy_delay: int = 1
    target_noise: float = 0.0
    noise_clip: float = 0.0
    twin_q: bool = False

    def build(self) -> "TD3":
        return DDPG(self)


class TD3:
    """``train()`` also reports its seconds split into sampling and
    learning (``sample_time_s``, ``learn_time_s``)."""

    def __init__(self, config: TD3Config):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        if not getattr(env, "continuous", False):
            raise ValueError(f"TD3 requires a continuous-action env, "
                             f"got {config.env!r}")
        self.obs_dim = env.obs_dim
        self.action_dim = env.action_dim
        self.action_low = float(getattr(env, "action_low", -1.0))
        self.action_high = float(getattr(env, "action_high", 1.0))
        self.params = init_td3(config.seed, self.obs_dim, self.action_dim,
                               config.hidden, twin_q=config.twin_q,
                               device=self.device)
        self.targets = frozen_tree(self.params)
        self.tx = adam(config.lr)
        self.opt_state = init_opt_state(self.tx, leaves(self.params))
        self.buffer = ReplayBuffer(config.buffer_capacity, self.obs_dim,
                                   action_shape=(self.action_dim,),
                                   action_dtype=np.float32,
                                   gamma=config.gamma)
        self.iteration = 0
        self.update_count = 0
        self.rng = np.random.default_rng(config.seed)
        self.noise_gen = torch.Generator().manual_seed(config.seed + 1)
        self.workers = [
            _TD3RolloutWorker(config.env, config.seed + 1000 * (i + 1),
                              config.expl_noise)
            for i in range(config.num_rollout_workers)
        ]
        self._update = partial(
            _td3_update, tx=self.tx, gamma=config.gamma, tau=config.tau,
            target_noise=config.target_noise,
            noise_clip=config.noise_clip, twin_q=config.twin_q)

    def _noise(self, batch_size: int) -> np.ndarray:
        """An update's standard-normal smoothing draw, [batch,
        action_dim]."""
        return torch.randn((batch_size, self.action_dim),
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
                self.update_count += 1
                do_policy = self.update_count % cfg.policy_delay == 0
                metrics = self._update(self.params, self.targets,
                                       self.opt_state, mb, noise, do_policy)
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
        with torch.no_grad():
            a = _pi(self.params["actor"], torch.as_tensor(
                np.asarray(obs, np.float32)[None], device=self.device))
        a = a.cpu().numpy()[0]
        return self.action_low + (a + 1.0) * 0.5 * (
            self.action_high - self.action_low)

    def stop(self):
        pass


class DDPG(TD3):
    """DDPG via its TD3 generalization (see DDPGConfig)."""
