"""DQN on PyTorch: epsilon-greedy rollout workers + replay + a TD update
on the card.

Port of ``ray_tpu/rllib/dqn.py`` (reference analog:
``rllib/algorithms/dqn/``: replay buffer, target network updates,
double-Q, dueling heads and C51's distributional head). The pieces keep
JAX's names:

- the Q-network is the port's ``PolicyValueMLP`` (``rllib.ppo``), the
  "pi" head serving as Q values (or C51's ``n_actions * num_atoms``
  logits) and the value head as the dueling V, so JAX's parameter tree
  and save file map onto it name for name
  (``convert.policy_value_from_numpy``);
- the replay ring, the rollout worker and ``_np_q`` are numpy, copied
  verbatim (``:53-159``);
- the updates ``_dqn_update`` (``:348``) and ``_c51_update`` (``:382``)
  take the learner's tensors on its device and step the parameters in
  place with ``adam(lr)``, optax's ``adam`` as the port's ``AdamW``.

The rollout workers are objects of this process, stepped one after
another with JAX's seeds (``seed + 1000*(i+1)``). Entry points run on the
card (``DQNConfig.device``, default "cuda") unless the config asks for
the CPU.
"""

from __future__ import annotations

import copy
import pickle
import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import _np_forward, adam, init_module


def init_qnet(seed: int, obs_dim: int, n_actions: int, hidden: int = 64,
              num_atoms: int = 1, *, device="cuda"):
    """num_atoms > 1 -> C51 head: the "pi" head emits n_actions *
    num_atoms logits reshaped to per-action distributions."""
    return init_module(seed, obs_dim, n_actions * num_atoms, hidden,
                       device=device)


def q_forward(params, obs: torch.Tensor, *, dueling: bool = False):
    logits, value = params(obs)
    if dueling:
        # Q = V + A - mean_a A (Wang et al.): the module's value head as V,
        # the action head as advantages
        return value[:, None] + logits - logits.mean(-1, keepdim=True)
    return logits


def dist_forward(params, obs: torch.Tensor, n_actions: int,
                 num_atoms: int) -> torch.Tensor:
    """C51: per-action categorical distributions [B, A, atoms]."""
    logits, _ = params(obs)
    return torch.softmax(logits.reshape(-1, n_actions, num_atoms), dim=-1)


def _np_q(params, obs, num_atoms: int = 1, support=None):
    logits, _ = _np_forward(params, obs)
    if num_atoms > 1:
        z = logits.reshape(len(obs), -1, num_atoms)
        z = np.exp(z - z.max(-1, keepdims=True))
        probs = z / z.sum(-1, keepdims=True)
        return probs @ support          # expected values [B, A]
    return logits


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``; float64 columns (an offline
    dataset's rewards and dones) become float32, as JAX's jit takes
    them."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def adam_step(tx, opt_state: dict, leaves: list,
              total: torch.Tensor) -> None:
    """One step of ``tx`` on ``leaves`` in place from the gradients of
    ``total``; a leaf ``total`` does not reach gets zeros, as
    ``jax.grad`` gives."""
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    tx.update(leaves, [torch.zeros_like(p) if g is None else g
                       for p, g in zip(leaves, grads)], opt_state)


def init_opt_state(tx, leaves: list) -> dict:
    """``tx.init`` over a flat list of leaves (in that order)."""
    return tx.init({str(i): p for i, p in enumerate(leaves)})


def frozen_copy(module):
    """A copy of ``module`` that takes no gradient (a target network)."""
    return copy.deepcopy(module).requires_grad_(False)


@torch.no_grad()
def copy_into(dst, src) -> None:
    """``dst``'s parameters set to ``src``'s (a hard target sync)."""
    for d, s in zip(dst.parameters(), src.parameters(), strict=True):
        d.copy_(s)


# ---------------------------------------------------------------------------
# Replay and rollouts (host code, copied from the JAX package)
# ---------------------------------------------------------------------------

class ReplayBuffer:
    """Uniform ring buffer (reference:
    ``rllib/utils/replay_buffers/replay_buffer.py``). ``action_shape``/
    ``action_dtype`` cover discrete (scalar int) and continuous (vector
    float) action spaces with one implementation."""

    def __init__(self, capacity: int, obs_dim: int,
                 action_shape: tuple = (), action_dtype=np.int32,
                 gamma: float = 0.99):
        self.capacity = capacity
        self.gamma = gamma
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, *action_shape), action_dtype)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        # per-transition bootstrap factor; always allocated so ring
        # slots can't silently hold stale values when some batches
        # carry "discounts" and others don't
        self.discounts = np.zeros((capacity,), np.float32)
        self.size = 0
        self.pos = 0

    def add_batch(self, batch: dict):
        """Vectorized ring insert: at most two slice assignments per
        field (wraparound)."""
        n = len(batch["obs"])
        if n == 0:
            return
        if n >= self.capacity:  # keep only the newest capacity items
            batch = {k: v[-self.capacity:] for k, v in batch.items()}
            n = self.capacity
        if "discounts" not in batch:
            # derive the 1-step bootstrap factor so every slot is valid
            batch = dict(batch)
            batch["discounts"] = (self.gamma
                                  * (1.0 - batch["dones"])).astype(np.float32)
        fields = [("obs", self.obs), ("next_obs", self.next_obs),
                  ("actions", self.actions), ("rewards", self.rewards),
                  ("dones", self.dones), ("discounts", self.discounts)]
        first = min(n, self.capacity - self.pos)
        for name, dst in fields:
            src = batch[name]
            dst[self.pos:self.pos + first] = src[:first]
            if n > first:
                dst[:n - first] = src[first:]
        self.pos = (self.pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch_size: int, rng) -> dict:
        idx = rng.integers(0, self.size, size=batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx],
                "discounts": self.discounts[idx]}


class _DQNRolloutWorker:
    def __init__(self, env_name, seed: int, num_atoms: int = 1,
                 support=None):
        self.env = make_env(env_name, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.obs = self.env.reset()
        self.ep_ret = 0.0
        self.num_atoms = num_atoms
        self.support = None if support is None else np.asarray(support)

    def sample(self, params_np: dict, num_steps: int, epsilon: float):
        obs_l, next_l, act_l, rew_l, done_l = [], [], [], [], []
        episode_returns = []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.rng.integers(self.env.n_actions))
            else:
                action = int(np.argmax(_np_q(
                    params_np, self.obs[None], self.num_atoms,
                    self.support)[0]))
            next_obs, reward, done, _ = self.env.step(action)
            obs_l.append(self.obs)
            next_l.append(next_obs)
            act_l.append(action)
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
                "actions": np.asarray(act_l, np.int32),
                "rewards": np.asarray(rew_l, np.float32),
                "dones": np.asarray(done_l, np.float32),
                "episode_returns": episode_returns}


# ---------------------------------------------------------------------------
# Config + Algorithm
# ---------------------------------------------------------------------------

@dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    num_updates_per_iter: int = 32
    target_update_freq: int = 4      # iterations between hard target syncs
    double_q: bool = True
    dueling: bool = False            # Q = V + A - mean(A)
    # C51 distributional Q (Bellemare et al.): num_atoms > 1 switches
    # the head to per-action categorical distributions over
    # [v_min, v_max] with a projected-Bellman cross-entropy loss
    num_atoms: int = 1
    v_min: float = -10.0
    v_max: float = 10.0
    n_step: int = 1                  # n-step return folding before insert
    prioritized_replay: bool = False
    pr_alpha: float = 0.6            # priority exponent
    pr_beta0: float = 0.4            # IS-weight exponent, annealed -> 1
    pr_beta_iters: int = 100
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 30
    hidden: int = 64
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "DQNConfig":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "DQNConfig":
        return replace(self, **kw)

    def training(self, **kw) -> "DQNConfig":
        return replace(self, **kw)

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """``train()`` also reports its seconds split into sampling and
    learning (``sample_time_s``, ``learn_time_s``)."""

    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer

        self.config = config
        if config.dueling and config.num_atoms > 1:
            raise ValueError("dueling + distributional (C51) is not "
                             "supported together; pick one")
        if config.num_atoms > 1 and config.v_max <= config.v_min:
            raise ValueError(
                f"C51 needs v_max > v_min, got [{config.v_min}, "
                f"{config.v_max}] (a degenerate support trains nothing)")
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        self.obs_dim = env.obs_dim
        self.n_actions = env.n_actions
        self.support = (np.linspace(config.v_min, config.v_max,
                                    config.num_atoms, dtype=np.float32)
                        if config.num_atoms > 1 else None)
        self.params = init_qnet(config.seed, self.obs_dim, self.n_actions,
                                config.hidden, config.num_atoms,
                                device=self.device)
        self.target_params = frozen_copy(self.params)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(dict(self.params.named_parameters()))
        if config.prioritized_replay:
            self.buffer = PrioritizedReplayBuffer(
                config.buffer_capacity, self.obs_dim,
                alpha=config.pr_alpha, gamma=config.gamma)
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity,
                                       self.obs_dim, gamma=config.gamma)
        self.iteration = 0
        self.rng = np.random.default_rng(config.seed)
        self.workers = [
            _DQNRolloutWorker(config.env, config.seed + 1000 * (i + 1),
                              config.num_atoms, self.support)
            for i in range(config.num_rollout_workers)
        ]
        if config.num_atoms > 1:
            self._update = partial(
                _c51_update, tx=self.tx, double_q=config.double_q,
                n_actions=self.n_actions, num_atoms=config.num_atoms,
                v_min=config.v_min, v_max=config.v_max)
        else:
            self._update = partial(
                _dqn_update, tx=self.tx, double_q=config.double_q,
                dueling=config.dueling)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def train(self) -> dict:
        from ray_tpu_torch.rllib.replay import nstep_batch

        cfg = self.config
        t0 = time.perf_counter()
        params_np = self.params.numpy_tree()
        eps = self._epsilon()
        batches = [w.sample(params_np, cfg.rollout_fragment_length, eps)
                   for w in self.workers]
        episode_returns = []
        for b in batches:
            episode_returns.extend(b.pop("episode_returns"))
            # per-worker batches are time-ordered, which n-step folding
            # needs; discounts carry the bootstrap factor either way
            self.buffer.add_batch(nstep_batch(b, cfg.n_step, cfg.gamma))
        t1 = time.perf_counter()

        beta = min(1.0, cfg.pr_beta0 + (1.0 - cfg.pr_beta0)
                   * self.iteration / max(1, cfg.pr_beta_iters))
        losses = []
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                if cfg.prioritized_replay:
                    mb = self.buffer.sample(cfg.train_batch_size,
                                            self.rng, beta=beta)
                    idx = mb.pop("idx")
                else:
                    mb = self.buffer.sample(cfg.train_batch_size,
                                            self.rng)
                    mb["weights"] = np.ones(len(mb["obs"]), np.float32)
                    idx = None
                loss, td = self._update(self.params, self.opt_state,
                                        self.target_params,
                                        to_device(mb, self.device))
                if idx is not None:
                    self.buffer.update_priorities(idx, td.cpu().numpy())
                losses.append(loss)
        losses = torch.stack(losses).tolist() if losses else []
        self.iteration += 1
        if self.iteration % cfg.target_update_freq == 0:
            copy_into(self.target_params, self.params)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(episode_returns))
                                    if episode_returns else 0.0),
            "num_episodes": len(episode_returns),
            "td_loss": float(np.mean(losses)) if losses else None,
            "epsilon": eps,
            "buffer_size": self.buffer.size,
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_action(self, obs) -> int:
        return int(np.argmax(_np_q(self.params.numpy_tree(),
                                   np.asarray(obs)[None],
                                   self.config.num_atoms,
                                   self.support)[0]))

    def save(self, path: str):
        """JAX's checkpoint format: a pickle of the numpy parameter tree."""
        with open(path, "wb") as f:
            pickle.dump(self.params.numpy_tree(), f)

    def restore(self, path: str):
        """Load a pickle of a numpy parameter tree (this port's or the JAX
        package's ``save``); the target network takes it too."""
        from ray_tpu_torch import convert

        with open(path, "rb") as f:
            self.params = convert.policy_value_from_numpy(
                pickle.load(f), device=self.device)
        self.target_params = frozen_copy(self.params)

    def stop(self):
        pass


# ---------------------------------------------------------------------------
# The updates
# ---------------------------------------------------------------------------

def _dqn_update(params, opt_state, target_params, batch, *, tx, double_q,
                dueling=False):
    """Weighted TD update (``ray_tpu/rllib/dqn.py:348``), in place.
    ``batch["discounts"]`` is the bootstrap factor (gamma for 1-step,
    gamma^h with terminal zeroing for n-step); ``batch["weights"]`` are IS
    weights (ones for uniform replay). Returns the loss and the per-sample
    |TD| for priority refresh."""
    q = q_forward(params, batch["obs"], dueling=dueling)
    q_taken = q.gather(1, batch["actions"].long()[:, None]).squeeze(-1)
    with torch.no_grad():
        q_next_target = q_forward(target_params, batch["next_obs"],
                                  dueling=dueling)
        if double_q:
            # online net selects, target net evaluates
            sel = q_forward(params, batch["next_obs"],
                            dueling=dueling).argmax(-1)
            next_q = q_next_target.gather(1, sel[:, None]).squeeze(-1)
        else:
            next_q = q_next_target.max(-1).values
        target = batch["rewards"] + batch["discounts"] * next_q
    td = q_taken - target
    loss = torch.mean(batch["weights"] * td ** 2)
    adam_step(tx, opt_state, list(params.parameters()), loss)
    return loss.detach(), td.detach().abs()


def _c51_project(p_next, rewards, discounts, support, v_min, v_max,
                 delta) -> torch.Tensor:
    """The target distribution Tz = clip(r + discount * z) projected onto
    the support (``ray_tpu/rllib/dqn.py:411-425``): [B, Z]. ``delta`` is a
    0-d tensor on the batch's device, so the card divides as the CPU does
    (CUDA turns a division by a host scalar into a product with its
    reciprocal, which can move an integral ``b`` off its atom)."""
    tz = torch.clamp(rewards[:, None] + discounts[:, None] * support[None, :],
                     v_min, v_max)                            # [B, Z]
    b = (tz - v_min) / delta
    lo = torch.floor(b).long()
    hi = torch.ceil(b).long()
    # when b is integral lo == hi: give it full mass via the lo term
    w_hi = b - lo
    w_lo = 1.0 - w_hi
    atoms = torch.arange(support.shape[0], device=support.device)
    # m[k] = sum_j p_next[j] * (w_lo[j]·[lo_j==k] + w_hi[j]·[hi_j==k])
    return (torch.where(lo[:, :, None] == atoms, (p_next * w_lo)[:, :, None],
                        0.0).sum(1)
            + torch.where(hi[:, :, None] == atoms,
                          (p_next * w_hi)[:, :, None], 0.0).sum(1))


def _c51_update(params, opt_state, target_params, batch, *, tx, double_q,
                n_actions, num_atoms, v_min, v_max):
    """C51 projected-Bellman update (Bellemare et al. 2017;
    ``ray_tpu/rllib/dqn.py:382``), in place: cross entropy of the online
    distribution of the taken action against the projected target.
    ``discounts`` already carries terminal zeroing and n-step gamma^h, so
    termination collapses Tz to a point mass at the (clipped) reward.
    Returns the loss and the per-sample cross entropy as the priority
    signal."""
    dev = batch["obs"].device
    support = torch.linspace(v_min, v_max, num_atoms, device=dev)
    delta = torch.tensor((v_max - v_min) / (num_atoms - 1),
                         dtype=torch.float32, device=dev)
    rows = torch.arange(batch["obs"].shape[0], device=dev)
    with torch.no_grad():
        # next-state distribution of the greedy action
        next_target = dist_forward(target_params, batch["next_obs"],
                                   n_actions, num_atoms)      # [B, A, Z]
        if double_q:
            next_online = dist_forward(params, batch["next_obs"],
                                       n_actions, num_atoms)
            sel = (next_online @ support).argmax(-1)
        else:
            sel = (next_target @ support).argmax(-1)
        m = _c51_project(next_target[rows, sel], batch["rewards"],
                         batch["discounts"], support, v_min, v_max, delta)
    online = dist_forward(params, batch["obs"], n_actions, num_atoms)
    p_taken = online[rows, batch["actions"].long()]
    xent = -(m * torch.log(p_taken + 1e-8)).sum(-1)           # [B]
    loss = torch.mean(batch["weights"] * xent)
    adam_step(tx, opt_state, list(params.parameters()), loss)
    return loss.detach(), xent.detach()
