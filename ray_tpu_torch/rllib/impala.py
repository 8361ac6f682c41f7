"""IMPALA on PyTorch: trajectory workers + V-trace off-policy correction.

Port of ``ray_tpu/rllib/impala.py`` (reference analog:
``rllib/algorithms/impala/``). Rollout workers collect fixed-length
trajectories under a behavior policy that lags the learner by one update;
the learner corrects the off-policyness with V-trace (Espeholt et al.
2018). ``vtrace`` is the reverse ``lax.scan`` of JAX as a reverse loop
over T of ``[B]`` tensors; the loss (``impala_loss``, with APPO's clipped
surrogate under ``clip_param``) runs on PPO's module, or with ``cell``
("gru" or "lstm") on ``rllib.recurrent``'s module: the forward is then
the recurrent sequence forward from the state each worker recorded at
its unroll's first step (``h0``), and the bootstrap value one more cell
step from the carried state.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (_episode_mean, _np_forward,
                                     _sample_actions, _softmax_rows, adam,
                                     entropy_of, init_module, logp_of)
from ray_tpu_torch.rllib.recurrent import (_cell_step,
                                           forward_recurrent_seq,
                                           init_recurrent_module,
                                           np_recurrent_step, zero_state)

# the columns of a trajectory batch (a recurrent core adds "h0")
TRAJECTORY_KEYS = ("obs", "actions", "behavior_logits", "rewards", "dones",
                   "bootstrap_obs")


class _TrajectoryWorker:
    """Collects fixed-length trajectories with behavior logits recorded
    for V-trace. VECTORIZED over ``num_envs`` environments: each step
    runs one batched policy forward for all envs (reference: vectorized
    EnvRunner — the round-3 one-env-per-forward weakness). The host code
    of JAX's worker (``ray_tpu/rllib/impala.py:24``)."""

    def __init__(self, env_name, seed: int, num_envs: int = 1,
                 cell: str | None = None):
        self.envs = [make_env(env_name, seed=seed + i)
                     for i in range(num_envs)]
        self.rng = np.random.default_rng(seed)
        self.obs = np.stack([e.reset() for e in self.envs])   # [E, obs]
        self.ep_ret = np.zeros(num_envs)
        self.num_envs = num_envs
        # recurrent core (reference: recurrent_net.py:25): the worker
        # CARRIES its state across unrolls and records the state at
        # each unroll's first step so the learner's scan replays it
        self.cell = cell
        self.state = None

    def sample(self, params_np: dict, unroll_length: int):
        T, ne = unroll_length, self.num_envs
        recurrent = self.cell is not None
        if recurrent:
            if self.state is None:
                self.state = zero_state(params_np, ne)
            h0 = self.state.copy()
        obs_l, act_l, logits_l, rew_l, done_l = [], [], [], [], []
        episode_returns = []
        for _ in range(T):
            if recurrent:
                logits, _, self.state = np_recurrent_step(
                    params_np, self.obs, self.state)
            else:
                logits, _ = _np_forward(params_np, self.obs)  # [E, A]
            probs = _softmax_rows(logits)
            actions = _sample_actions(self.rng, probs)
            obs_l.append(self.obs.copy())
            act_l.append(actions)
            logits_l.append(logits)
            step_rew = np.zeros(ne, np.float32)
            step_done = np.zeros(ne, np.float32)
            for i, env in enumerate(self.envs):
                o, r, d, _ = env.step(int(actions[i]))
                step_rew[i] = r
                step_done[i] = float(d)
                self.ep_ret[i] += r
                if d:
                    episode_returns.append(float(self.ep_ret[i]))
                    self.ep_ret[i] = 0.0
                    o = env.reset()
                    if recurrent:
                        self.state[i] = 0.0   # fresh episode, fresh memory
                self.obs[i] = o
            rew_l.append(step_rew)
            done_l.append(step_done)
        # [T, E, ...] -> [E, T, ...] (the learner stacks over the batch
        # axis; each env is one trajectory)
        out = {
            "obs": np.stack(obs_l).swapaxes(0, 1).astype(np.float32),
            "actions": np.stack(act_l).swapaxes(0, 1).astype(np.int32),
            "behavior_logits": np.stack(logits_l).swapaxes(0, 1).astype(
                np.float32),
            "rewards": np.stack(rew_l).swapaxes(0, 1),
            "dones": np.stack(done_l).swapaxes(0, 1),
            "bootstrap_obs": self.obs.copy().astype(np.float32),
            "episode_returns": episode_returns,
        }
        if recurrent:
            out["h0"] = h0
        return out


@dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    # envs stepped in lockstep per worker (one batched forward per step)
    num_envs_per_worker: int = 1
    unroll_length: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    rho_clip: float = 1.0     # V-trace rho-bar
    c_clip: float = 1.0       # V-trace c-bar
    # None = plain V-trace policy gradient; a float enables the APPO
    # clipped surrogate (see rllib/appo.py)
    clip_param: float | None = None
    hidden: int = 64
    # recurrent policy core (reference: recurrent_net.py:25 — LSTM/GRU
    # wrapping for POMDP envs): None = feedforward MLP
    cell: str | None = None
    seed: int = 0
    # multi-learner plane (rllib.learner_group)
    num_learners: int = 0
    learner_mode: str = "mesh"
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "IMPALAConfig":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "IMPALAConfig":
        return replace(self, **kw)

    def training(self, **kw) -> "IMPALAConfig":
        return replace(self, **kw)

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """A synchronous loop over the async algorithm's math: workers
    sample with the PREVIOUS iteration's params (one-step policy lag,
    like the reference's in-flight sample batches), and V-trace corrects
    the drift. The workers run in this process: each ``train()`` samples
    the next round with the parameters it read before its update, as
    JAX's in-flight samples are."""

    def __init__(self, config: IMPALAConfig):
        from ray_tpu_torch.rllib.learner_group import build_learner

        self.config = config
        env = make_env(config.env, seed=config.seed)
        self.obs_dim = env.obs_dim
        self.n_actions = env.n_actions
        self.iteration = 0
        self.workers = [
            _TrajectoryWorker(config.env, config.seed + 1000 * (i + 1),
                              config.num_envs_per_worker, config.cell)
            for i in range(config.num_rollout_workers)
        ]
        dims = dict(obs_dim=self.obs_dim, n_actions=self.n_actions,
                    hidden=config.hidden)
        self.learner = build_learner(
            init_fn=partial(init_module, **dims) if config.cell is None
            else partial(init_recurrent_module, cell=config.cell, **dims),
            loss_fn=partial(
                impala_loss, gamma=config.gamma, rho_clip=config.rho_clip,
                c_clip=config.c_clip, entropy_coeff=config.entropy_coeff,
                vf_coeff=config.vf_coeff, clip_param=config.clip_param,
                cell=config.cell),
            tx=adam(config.lr), num_learners=config.num_learners,
            mode=config.learner_mode, seed=config.seed,
            device=config.device)
        self._inflight = None  # the next round, sampled with lagged params

    def _params_np(self):
        params = self.learner.get_params()
        if self.config.cell is not None:
            params = {**params, "cell_type": self.config.cell}
        return params

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        params_np = self._params_np()
        if self._inflight is None:  # first iteration: no lag yet
            self._inflight = [w.sample(params_np, cfg.unroll_length)
                              for w in self.workers]
        batches = self._inflight
        # the NEXT round with the current params: one update stale by the
        # time the learner uses it (the lag V-trace exists to correct)
        self._inflight = [w.sample(params_np, cfg.unroll_length)
                          for w in self.workers]

        episode_returns = [r for b in batches
                           for r in b["episode_returns"]]
        # concatenate env trajectories to [B, T, ...] (each worker
        # contributes num_envs_per_worker trajectories)
        keys = list(TRAJECTORY_KEYS)
        if cfg.cell is not None:
            keys.append("h0")
        batch = {k: np.concatenate([b[k] for b in batches]) for k in keys}
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
            "mean_rho": stats["mean_rho"],
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_action(self, obs, state=None):
        """The greedy action; with a ``cell``, also the new recurrent
        state (pass it back for the episode's next step; None starts
        one)."""
        params = self._params_np()
        if self.config.cell is not None:
            if state is None:
                state = zero_state(params, 1)
            logits, _, state = np_recurrent_step(
                params, np.asarray(obs, np.float32)[None], state)
            return int(np.argmax(logits[0])), state
        logits, _ = _np_forward(params, np.asarray(obs)[None])
        return int(np.argmax(logits[0]))

    def save(self, path: str):
        """JAX's checkpoint format: a pickle of the numpy parameter tree
        (with ``cell_type`` for a recurrent core)."""
        with open(path, "wb") as f:
            pickle.dump(self._params_np(), f)

    def restore(self, path: str):
        """Load a pickle of a numpy parameter tree (this port's or the JAX
        package's ``save``) through ``convert.policy_value_from_numpy``, or
        ``convert.recurrent_from_numpy`` for a recurrent core."""
        with open(path, "rb") as f:
            self.learner.set_params(pickle.load(f))

    def stop(self):
        self.learner.stop()


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           dones, *, gamma, rho_clip, c_clip):
    """V-trace targets (Espeholt et al. 2018, eq. 1; ``ray_tpu/rllib/
    impala.py:313``): the reverse scan over time as a loop over T of
    ``[B]`` tensors. Inputs are time-major ``[T, B]``; returns (vs,
    pg_adv, rho), none carrying a gradient (JAX stops vs's and pg_adv's;
    its rho feeds only the ``mean_rho`` stat)."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=c_clip)
    discounts = gamma * (1.0 - dones)

    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho_bar * (rewards + discounts * values_next - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * c_bar[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    # advantage for the policy gradient uses vs_{t+1}
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho_bar * (rewards + discounts * vs_next - values)
    return vs, pg_adv, rho


def impala_loss(module, batch: dict, *, gamma, rho_clip, c_clip,
                entropy_coeff, vf_coeff, clip_param=None, cell=None):
    """The loss of ``_impala_grads`` (``ray_tpu/rllib/impala.py:344``) on a
    ``[B, T, ...]`` batch of tensors: the V-trace policy gradient (or,
    with ``clip_param``, APPO's clipped surrogate on the V-trace
    advantage), the value loss against vs and the entropy bonus. With
    ``cell``, ``module`` is a ``RecurrentModule`` and the batch holds each
    trajectory's initial state ``h0``. Returns (total, stats)."""
    # batch is [B, T, ...]; V-trace wants time-major
    obs = batch["obs"].transpose(0, 1)                    # [T, B, obs]
    actions = batch["actions"].transpose(0, 1)            # [T, B]
    behavior_logits = batch["behavior_logits"].transpose(0, 1)
    rewards = batch["rewards"].transpose(0, 1)
    dones = batch["dones"].transpose(0, 1)
    T, B = actions.shape

    if cell is not None:
        p = module.tree()
        logits_bt, values_bt, h_final = forward_recurrent_seq(
            p, batch["obs"], batch["h0"], batch["dones"])
        logits = logits_bt.transpose(0, 1)
        values = values_bt.transpose(0, 1)
        # bootstrap value: one more cell step from the carried state
        # (zeroed where the last unroll step ended an episode — the
        # bootstrap obs is then a fresh reset)
        h_boot = h_final * (1.0 - batch["dones"][:, -1])[:, None]
        x = torch.tanh(batch["bootstrap_obs"] @ p["enc"]["w"]
                       + p["enc"]["b"])
        h, _ = _cell_step(p, x, h_boot, torch)
        bootstrap_value = (h @ p["vf"]["w"] + p["vf"]["b"]).squeeze(-1)
    else:
        logits, values = module(obs.reshape(T * B, -1))
        logits = logits.reshape(T, B, -1)
        values = values.reshape(T, B)
        _, bootstrap_value = module(batch["bootstrap_obs"])

    logp_all = torch.log_softmax(logits, dim=-1)
    target_logp = logp_of(logp_all, actions)
    behavior_logp = logp_of(torch.log_softmax(behavior_logits, dim=-1),
                            actions)

    vs, pg_adv, rho = vtrace(
        behavior_logp, target_logp, rewards, values, bootstrap_value,
        dones, gamma=gamma, rho_clip=rho_clip, c_clip=c_clip)

    if clip_param is not None:
        # APPO: PPO clipped surrogate on the V-trace advantage
        ratio = torch.exp(target_logp - behavior_logp)
        clipped = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param)
        policy_loss = -torch.mean(
            torch.minimum(ratio * pg_adv, clipped * pg_adv))
    else:
        policy_loss = -torch.mean(target_logp * pg_adv)
    vf_loss = torch.mean((values - vs) ** 2)
    entropy = entropy_of(logp_all)
    total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "entropy": entropy, "mean_rho": torch.mean(rho)}
