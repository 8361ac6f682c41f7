"""Recurrent (GRU/LSTM) policy cores + sequence-aware PPO, on PyTorch.

Port of ``ray_tpu/rllib/recurrent.py`` (reference analog:
``rllib/models/torch/recurrent_net.py:25`` and the sequence handling of
``rllib/policy/rnn_sequencing.py``: fragments carry their initial
recurrent state; padding is masked out of the loss).

- The module is ``RecurrentModule``: encoder -> GRU/LSTM cell -> pi/vf
  heads, each a ``Dense`` in JAX's ``[fan_in, fan_out]`` layout, so JAX's
  tree ``{cell_type, enc, cell, pi, vf}`` maps onto it name for name
  (``convert.recurrent_from_numpy``).
- ``_cell_step`` is JAX's function, shared between numpy (the rollout
  workers) and torch (the learner) as JAX's is between numpy and jnp: the
  workers replay bit for bit what JAX's workers compute.
- ``forward_recurrent_seq`` is JAX's ``lax.scan`` over T as a loop over T
  of ``[B, H]`` tensors; an episode end inside a fragment zeroes the
  carried state before the next step.
- ``_rppo_update`` is one masked clipped-surrogate step with ``adam(lr)``
  on the module, in place.

The rollout worker is numpy, copied verbatim, and runs in this process
with JAX's seeds (``seed + 1000*(i+1)``). ``RecurrentPPOConfig.device``
defaults to "cuda".
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.learner_group import sgd_step
from ray_tpu_torch.rllib.ppo import (Dense, _episode_mean, _gae,
                                     _sample_actions, _softmax_rows, adam,
                                     logp_of)

LAYERS = ("enc", "cell", "pi", "vf")


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

class RecurrentModule(nn.Module):
    """JAX's ``init_recurrent_module`` tree as a module: ``cell_type`` and
    one ``Dense`` a layer of ``LAYERS``. ``tree()`` gives the parameters
    as JAX's tree of tensors, which ``_cell_step`` and
    ``forward_recurrent_seq`` read."""

    def __init__(self, tree: dict, cell_type: str):
        super().__init__()
        if cell_type not in ("gru", "lstm"):
            raise ValueError(
                f"cell must be 'gru' or 'lstm', got {cell_type!r}")
        self.cell_type = cell_type
        for name in LAYERS:
            setattr(self, name, Dense(tree[name]["w"], tree[name]["b"]))

    def tree(self) -> dict:
        return {"cell_type": self.cell_type,
                **{name: {"w": getattr(self, name).w,
                          "b": getattr(self, name).b} for name in LAYERS}}

    @torch.no_grad()
    def numpy_tree(self) -> dict:
        """The parameters as JAX's numpy tree without ``cell_type`` (what
        JAX's learners hold), copied to the host in one transfer."""
        params = list(self.parameters())
        flat = torch.cat([p.reshape(-1) for p in params]).cpu().numpy()
        leaves = iter(np.split(flat, np.cumsum([p.numel()
                                                for p in params])[:-1]))
        return {name: {leaf: next(leaves).reshape(p.shape)
                       for leaf, p in getattr(self, name).named_parameters()}
                for name in LAYERS}


def init_recurrent_module(seed: int, obs_dim: int, n_actions: int,
                          hidden: int = 64, cell: str = "gru", *,
                          device="cuda") -> RecurrentModule:
    """Encoder -> GRU/LSTM cell -> pi/vf heads (``ray_tpu/rllib/
    recurrent.py:44``): the cell's gate products fused into one
    ``[2*hidden, gates*hidden]`` weight. He-normal ``w`` and zero ``b``,
    drawn in layer order from a CPU generator seeded with ``seed``."""
    if cell not in ("gru", "lstm"):
        raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
    gen = torch.Generator().manual_seed(seed)

    def dense(fan_in, fan_out):
        return {"w": torch.randn(fan_in, fan_out, generator=gen)
                * (2.0 / fan_in) ** 0.5,
                "b": torch.zeros(fan_out)}

    gates = 3 if cell == "gru" else 4
    tree = {"enc": dense(obs_dim, hidden),
            "cell": dense(2 * hidden, gates * hidden),
            "pi": dense(hidden, n_actions), "vf": dense(hidden, 1)}
    return RecurrentModule(tree, cell).to(resolve_device(device))


def state_size(params) -> int:
    h = params["cell"]["w"].shape[0] // 2
    return 2 * h if params["cell_type"] == "lstm" else h


def zero_state(params, batch: int) -> np.ndarray:
    return np.zeros((batch, state_size(params)), np.float32)


def _cell_step(params, x, state, np_mod):
    """One recurrent step. ``x``: [B, H] encoded obs; ``state``: [B, S].
    Shared between numpy (np_mod=np) and torch (np_mod=torch) callers —
    the rollout worker must replay bit-for-bit what the learner scans."""
    np_ = np_mod
    hidden = params["enc"]["w"].shape[1]
    if params["cell_type"] == "gru":
        h = state
        zin = np_.concatenate([x, h], axis=-1)
        g = zin @ params["cell"]["w"] + params["cell"]["b"]
        z = _sigmoid(g[:, :hidden], np_)
        r = _sigmoid(g[:, hidden:2 * hidden], np_)
        # candidate uses the RESET-gated hidden: recompute its block
        # with r*h (the fused matmul covers z/r; the candidate's hidden
        # half re-projects through the same weight slice)
        w_xc = params["cell"]["w"][:hidden, 2 * hidden:]
        w_hc = params["cell"]["w"][hidden:, 2 * hidden:]
        c = np_.tanh(x @ w_xc + (r * h) @ w_hc
                     + params["cell"]["b"][2 * hidden:])
        h_new = (1 - z) * h + z * c
        return h_new, h_new
    # lstm: state = [h | c]
    h, c = state[:, :hidden], state[:, hidden:]
    zin = np_.concatenate([x, h], axis=-1)
    g = zin @ params["cell"]["w"] + params["cell"]["b"]
    i = _sigmoid(g[:, :hidden], np_)
    f = _sigmoid(g[:, hidden:2 * hidden] + 1.0, np_)   # forget bias 1
    o = _sigmoid(g[:, 2 * hidden:3 * hidden], np_)
    cand = np_.tanh(g[:, 3 * hidden:])
    c_new = f * c + i * cand
    h_new = o * np_.tanh(c_new)
    return h_new, np_.concatenate([h_new, c_new], axis=-1)


def _sigmoid(x, np_):
    return 1.0 / (1.0 + np_.exp(-x))


def forward_recurrent_seq(params, obs_seq, h0, dones):
    """The sequence forward (``ray_tpu/rllib/recurrent.py:112``):
    ``params`` a tree of tensors (``RecurrentModule.tree()``), ``obs_seq``
    [B, T, obs], ``h0`` [B, S], ``dones`` [B, T] (1.0 AFTER the step at t
    ended an episode — the carried state is zeroed before step t+1).
    Returns (logits [B,T,A], values [B,T], h_final [B,S]), the scan a loop
    over T."""
    x = torch.tanh(obs_seq @ params["enc"]["w"] + params["enc"]["b"])
    # done BEFORE each step: shift the per-step dones right by one
    done_prev = torch.cat([torch.zeros_like(dones[:, :1]), dones[:, :-1]],
                          dim=1)
    state = h0
    hs = []
    for t in range(x.shape[1]):
        state = state * (1.0 - done_prev[:, t])[:, None]
        h, state = _cell_step(params, x[:, t], state, torch)
        hs.append(h)
    hs = torch.stack(hs, dim=1)                     # [B, T, H]
    logits = hs @ params["pi"]["w"] + params["pi"]["b"]
    values = (hs @ params["vf"]["w"] + params["vf"]["b"]).squeeze(-1)
    return logits, values, state


def np_recurrent_step(params, obs, state):
    """Rollout-side single step (numpy): [B, obs] x [B, S] ->
    (logits [B, A], values [B], new_state [B, S])."""
    x = np.tanh(obs @ params["enc"]["w"] + params["enc"]["b"])
    h, state = _cell_step(params, x, state, np)
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    values = (h @ params["vf"]["w"] + params["vf"]["b"]).squeeze(-1)
    return logits, values, state


# ---------------------------------------------------------------------------
# Memory envs (POMDPs), copied from the JAX package
# ---------------------------------------------------------------------------

class MemoryCueEnv:
    """T-maze-style memory probe: step 0 shows a cue (+1/-1), steps
    1..delay show zeros, and on the LAST step the agent must pick the
    action matching the cue. A memoryless policy earns 0.5 on average;
    remembering the cue earns 1.0 — clean, fast signal for recurrent
    policies (reference: the LSTM-requiring debug envs,
    rllib/examples/env/stateless_cartpole.py class of tests)."""

    obs_dim = 2
    n_actions = 2

    def __init__(self, seed: int | None = None, delay: int = 3):
        self.rng = np.random.default_rng(seed)
        self.delay = delay
        self.t = 0
        self.cue = 1.0

    def reset(self):
        self.t = 0
        self.cue = float(self.rng.choice([-1.0, 1.0]))
        return np.array([self.cue, 0.0], np.float32)

    def step(self, action: int):
        self.t += 1
        last = self.t >= self.delay
        if last:
            reward = 1.0 if (self.cue > 0) == (int(action) == 1) else 0.0
            return np.zeros(2, np.float32), reward, True, {}
        # countdown channel so the step index is observable (the TASK
        # stays memoryful: the cue itself is long gone)
        return np.array([0.0, (self.delay - self.t) / self.delay],
                        np.float32), 0.0, False, {}


class StatelessCartPole:
    """CartPole with the velocity components masked out (reference:
    ``rllib/examples/env/stateless_cartpole.py``): position + angle
    only — balancing requires estimating velocities from history."""

    obs_dim = 2
    n_actions = 2

    def __init__(self, seed: int | None = None):
        from ray_tpu_torch.rllib.env import CartPole

        self.env = CartPole(seed=seed)

    def reset(self):
        return self.env.reset()[[0, 2]]

    def step(self, action):
        obs, r, d, i = self.env.step(action)
        self.truncated = self.env.truncated
        return obs[[0, 2]], r, d, i


# ---------------------------------------------------------------------------
# Recurrent PPO
# ---------------------------------------------------------------------------

class _RecurrentRolloutWorker:
    """Collects FRAGMENTS of up to ``max_seq_len`` steps, each carrying
    the recurrent state at its first step (reference: rnn_sequencing's
    seq_lens + state_in batches). Fragments never cross episode ends;
    short fragments are zero-padded and masked. The host code of JAX's
    worker (``ray_tpu/rllib/recurrent.py:212``)."""

    def __init__(self, env_name, seed: int, max_seq_len: int):
        self.env = make_env(env_name, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.max_seq_len = max_seq_len

    def sample(self, params_np: dict, num_steps: int, gamma: float,
               lam: float):
        env = self.env
        T = self.max_seq_len
        frags = []     # dicts of [T, ...] padded columns
        episode_returns = []
        obs = env.reset()
        state = zero_state(params_np, 1)
        ep_ret = 0.0
        steps = 0
        while steps < num_steps:
            h0 = state[0].copy()
            cols = {k: [] for k in ("obs", "actions", "logp", "values",
                                    "rewards", "dones")}
            t = 0
            done = False
            while t < T and steps < num_steps:
                logits, value, state = np_recurrent_step(
                    params_np, obs[None], state)
                probs = _softmax_rows(logits)
                action = int(_sample_actions(self.rng, probs)[0])
                cols["obs"].append(obs.copy())
                cols["actions"].append(action)
                cols["logp"].append(
                    float(np.log(probs[0, action] + 1e-8)))
                cols["values"].append(float(value[0]))
                obs, r, done, _ = env.step(action)
                ep_ret += r
                cols["rewards"].append(float(r))
                cols["dones"].append(float(done))
                t += 1
                steps += 1
                if done:
                    episode_returns.append(ep_ret)
                    ep_ret = 0.0
                    obs = env.reset()
                    state = zero_state(params_np, 1)
                    break
            if done:
                last_v = 0.0
            else:
                _, v, _ = np_recurrent_step(params_np, obs[None], state)
                last_v = float(v[0])
            adv, ret = _gae(np.asarray(cols["rewards"]),
                            np.asarray(cols["values"]),
                            np.asarray(cols["dones"]), last_v,
                            gamma, lam)
            pad = T - t
            frag = {
                "obs": np.pad(np.asarray(cols["obs"], np.float32),
                              ((0, pad), (0, 0))),
                "actions": np.pad(
                    np.asarray(cols["actions"], np.int32), (0, pad)),
                "logp": np.pad(
                    np.asarray(cols["logp"], np.float32), (0, pad)),
                "advantages": np.pad(adv.astype(np.float32), (0, pad)),
                "returns": np.pad(ret.astype(np.float32), (0, pad)),
                "dones": np.pad(
                    np.asarray(cols["dones"], np.float32), (0, pad)),
                "mask": np.pad(np.ones(t, np.float32), (0, pad)),
                "h0": h0,
            }
            frags.append(frag)
        batch = {k: np.stack([f[k] for f in frags]) for k in frags[0]}
        batch["episode_returns"] = episode_returns
        return batch


BATCH_KEYS = ("obs", "actions", "logp", "advantages", "returns", "dones",
              "mask", "h0")


def normalize_masked(batch: dict) -> dict:
    """The advantages normalized over the unmasked steps and zeroed on the
    padding (``RecurrentPPO.train``), in numpy as JAX does."""
    m = batch["mask"]
    adv = batch["advantages"]
    mean = (adv * m).sum() / m.sum()
    std = np.sqrt(((adv - mean) ** 2 * m).sum() / m.sum()) + 1e-8
    return {**batch, "advantages": (adv - mean) / std * m}


def rppo_loss(module: RecurrentModule, batch: dict, *, clip_eps: float,
              entropy_coeff: float, vf_coeff: float):
    """The loss of ``_rppo_update`` (``ray_tpu/rllib/recurrent.py:416``)
    on ``[B, T]`` fragments of tensors: the clipped surrogate, the value
    loss and the entropy bonus, each averaged over the unmasked steps.
    Returns (total, stats)."""
    logits, values, _ = forward_recurrent_seq(
        module.tree(), batch["obs"], batch["h0"], batch["dones"])
    m = batch["mask"]
    n = m.sum()
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_of(logp_all, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    policy_loss = -(torch.minimum(unclipped, clipped) * m).sum() / n
    vf_loss = (((values - batch["returns"]) ** 2) * m).sum() / n
    ent = -(torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
            * m).sum() / n
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": ent}


def _rppo_update(module: RecurrentModule, opt_state: dict, batch: dict, *,
                 tx, clip_eps: float, entropy_coeff: float,
                 vf_coeff: float) -> dict:
    """One step of ``tx`` on ``module`` in place from ``rppo_loss``'s
    gradients (``ray_tpu/rllib/recurrent.py:416``); returns the stats
    (detached tensors) of the parameters before the step, as JAX's."""
    return sgd_step(partial(rppo_loss, clip_eps=clip_eps,
                            entropy_coeff=entropy_coeff, vf_coeff=vf_coeff),
                    module, opt_state, batch, tx)


@dataclass
class RecurrentPPOConfig:
    env: str = "CartPole-v1"
    cell: str = "gru"                  # "gru" | "lstm"
    max_seq_len: int = 16
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 256
    lr: float = 3e-3
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    num_sgd_iter: int = 4
    hidden: int = 32
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "RecurrentPPOConfig":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "RecurrentPPOConfig":
        return replace(self, **kw)

    def training(self, **kw) -> "RecurrentPPOConfig":
        return replace(self, **kw)

    def build(self) -> "RecurrentPPO":
        return RecurrentPPO(self)


class RecurrentPPO:
    """PPO over padded [B, T] fragments with per-fragment initial state
    (reference: the LSTM auto-wrapped PPO, recurrent_net.py:25): each of
    ``num_sgd_iter`` updates takes the whole batch. ``train()`` also
    reports its seconds split into sampling and learning."""

    def __init__(self, config: RecurrentPPOConfig):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        self.module = init_recurrent_module(
            config.seed, env.obs_dim, env.n_actions, config.hidden,
            config.cell, device=self.device)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(dict(self.module.named_parameters()))
        self._update = partial(
            _rppo_update, tx=self.tx, clip_eps=config.clip_eps,
            entropy_coeff=config.entropy_coeff, vf_coeff=config.vf_coeff)
        self.workers = [
            _RecurrentRolloutWorker(config.env, config.seed + 1000 * (i + 1),
                                    config.max_seq_len)
            for i in range(config.num_rollout_workers)
        ]
        self.iteration = 0

    def _params_np(self):
        return {**self.module.numpy_tree(), "cell_type": self.config.cell}

    def train(self) -> dict:
        from ray_tpu_torch.rllib.dqn import to_device

        cfg = self.config
        t0 = time.perf_counter()
        params_np = self._params_np()
        batches = [w.sample(params_np, cfg.rollout_fragment_length,
                            cfg.gamma, cfg.lam) for w in self.workers]
        episode_returns = [r for b in batches
                           for r in b["episode_returns"]]
        batch = normalize_masked({k: np.concatenate([b[k] for b in batches])
                                  for k in BATCH_KEYS})
        t1 = time.perf_counter()
        tensors = to_device(batch, self.device)
        for _ in range(cfg.num_sgd_iter):
            stats = self._update(self.module, self.opt_state, tensors)
        stats = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": _episode_mean(episode_returns),
            "num_episodes": len(episode_returns),
            "policy_loss": stats["policy_loss"],
            "entropy": stats["entropy"],
            "num_env_steps_sampled": int(batch["mask"].sum()),
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_action(self, obs, state=None):
        params_np = self._params_np()
        if state is None:
            state = zero_state(params_np, 1)
        logits, _, state = np_recurrent_step(
            params_np, np.asarray(obs, np.float32)[None], state)
        return int(np.argmax(logits[0])), state

    def stop(self):
        pass
