"""DreamerV3 (compact) on PyTorch: model-based RL via a recurrent
state-space world model (RSSM) + actor-critic trained on imagined
latent rollouts.

Port of ``ray_tpu/rllib/dreamer.py`` (reference analog:
``rllib/algorithms/dreamerv3/``: world model with categorical latents,
KL balancing + free bits, symlog heads, imagination horizon, REINFORCE
actor with return-range normalization). The networks are JAX's trees of
tensors (``x @ w + b``; the MLPs lists of layers, the GRU ``{wx, wh,
b}``), so a JAX tree maps onto them leaf for leaf
(``convert.dreamer_from_numpy``). ``_dreamer_update`` is JAX's one
program as one function with three gradient passes: the world model
over a [B, T] sequence batch (its posterior scan a loop over T), the
actor through an H-step imagination from every posterior state, then
the critic on the imagined lambda-returns; then the EMA target critic.

Noise is an input. JAX samples its categoricals inside the jit
(``jax.random.categorical``: the argmax of ``logits + gumbel``); the
port's update takes the Gumbel draws as tensors (``noise``: ``post``
[T, B, C, K] for the posterior steps, ``act`` [H, N, A] and ``prior``
[H, N, C, K] for the imagination, N = B*T). ``DreamerV3._noise`` draws
them from a CPU generator seeded with ``seed + 1``, so a CPU run and a
card run of the port draw the same numbers.

The rollout workers keep JAX's numpy mirror of the filtering policy
(encoder + GRU + posterior + actor) and the sequence replay, both copied
verbatim; the workers run in this process with JAX's seeds.
``DreamerV3Config.device`` defaults to "cuda".
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.dqn import adam_step, init_opt_state, to_device
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import _constant, adam
from ray_tpu_torch.rllib.sac import (_init_mlp, _mlp, _stopped, frozen_tree,
                                     leaves, numpy_tree)
from ray_tpu_torch.train.optim import AdamW


# ---------------------------------------------------------------------------
# small functional nets
# ---------------------------------------------------------------------------

def _init_gru(gen: torch.Generator, x_dim: int, h_dim: int, device) -> dict:
    def leaf(t):
        return t.to(device).requires_grad_()

    return {
        "wx": leaf(torch.randn(x_dim, 3 * h_dim, generator=gen)
                   * (x_dim ** -0.5)),
        "wh": leaf(torch.randn(h_dim, 3 * h_dim, generator=gen)
                   * (h_dim ** -0.5)),
        "b": leaf(torch.zeros(3 * h_dim)),
    }


def _gru(p, x, h):
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    zx, rx, cx = torch.chunk(gx, 3, dim=-1)
    zh, rh, ch = torch.chunk(gh, 3, dim=-1)
    z = torch.sigmoid(zx + zh)
    r = torch.sigmoid(rx + rh)
    cand = torch.tanh(cx + r * ch)
    return (1.0 - z) * h + z * cand


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


# numpy mirrors used by the rollout policy and greedy evaluation
def _np_mlp(p, x):
    for i, layer in enumerate(p):
        x = x @ layer["w"] + layer["b"]
        if i < len(p) - 1:
            x = np.tanh(x)
    return x


def _np_gru(p, x, h):
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    zx, rx, cx = np.split(gx, 3)
    zh, rh, ch = np.split(gh, 3)
    z = sig(zx + zh)
    r = sig(rx + rh)
    return (1.0 - z) * h + z * np.tanh(cx + r * ch)


def _np_softmax(lg):
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_symlog(x):
    return np.sign(x) * np.log1p(np.abs(x))


# ---------------------------------------------------------------------------
# RSSM core
# ---------------------------------------------------------------------------

def init_dreamer(seed: int, obs_dim: int, n_actions: int, *, embed: int,
                 h_dim: int, n_cats: int, n_classes: int, hidden: int,
                 device="cuda") -> dict:
    """``init_dreamer`` (``ray_tpu/rllib/dreamer.py:110``): every network
    drawn in JAX's order (the world model's encoder, GRU, prior,
    posterior, decoder, reward and continue heads, then the actor and the
    critic) from one CPU generator seeded with ``seed``, then moved."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    z_dim = n_cats * n_classes
    f_dim = h_dim + z_dim
    return {
        "wm": {
            "encoder": _init_mlp(gen, (obs_dim, hidden, embed), dev),
            "gru": _init_gru(gen, z_dim + n_actions, h_dim, dev),
            "prior": _init_mlp(gen, (h_dim, hidden, z_dim), dev),
            "post": _init_mlp(gen, (h_dim + embed, hidden, z_dim), dev),
            "decoder": _init_mlp(gen, (f_dim, hidden, obs_dim), dev),
            "reward": _init_mlp(gen, (f_dim, hidden, 1), dev),
            "cont": _init_mlp(gen, (f_dim, hidden, 1), dev),
        },
        "actor": _init_mlp(gen, (f_dim, hidden, n_actions), dev),
        "critic": _init_mlp(gen, (f_dim, hidden, 1), dev),
    }


def _categorical(logits, gumbel, record=None):
    """``jax.random.categorical``: the argmax over the last axis of
    ``logits + gumbel``. ``record`` (a list) receives the indices and
    each draw's margin, the gap between its two largest entries."""
    x = logits + gumbel
    idx = torch.argmax(x, dim=-1)
    if record is not None:
        top2 = torch.topk(x.detach(), 2, dim=-1).values
        record.append((idx, top2[..., 0] - top2[..., 1]))
    return idx


def _sample_onehot(logits, gumbel, n_cats, n_classes, *, unimix=0.01,
                   record=None):
    """Sample a categorical latent (one one-hot per category) with the
    1% uniform mixture and straight-through gradients (DreamerV3);
    ``gumbel`` [..., n_cats, n_classes] is the draw."""
    lg = logits.reshape(*logits.shape[:-1], n_cats, n_classes)
    probs = torch.softmax(lg, dim=-1)
    probs = (1.0 - unimix) * probs + unimix / n_classes
    idx = _categorical(torch.log(probs), gumbel, record)
    onehot = F.one_hot(idx, n_classes).to(probs.dtype)
    st = onehot + probs - probs.detach()                 # straight-through
    return st.reshape(*logits.shape[:-1], n_cats * n_classes)


def _kl_cats(lhs_logits, rhs_logits, n_cats, n_classes):
    """KL(lhs || rhs) between factorized categoricals, summed over cats."""
    a = lhs_logits.reshape(*lhs_logits.shape[:-1], n_cats, n_classes)
    b = rhs_logits.reshape(*rhs_logits.shape[:-1], n_cats, n_classes)
    pa = torch.softmax(a, dim=-1)
    return torch.sum(pa * (torch.log_softmax(a, dim=-1)
                           - torch.log_softmax(b, dim=-1)), dim=(-2, -1))


def _sigmoid_bce(logits, labels):
    """``optax.sigmoid_binary_cross_entropy`` (its log-sigmoid form)."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


# ---------------------------------------------------------------------------
# the one update
# ---------------------------------------------------------------------------

def _dreamer_update(params, target_critic, opt_wm, opt_actor, opt_critic,
                    ret_scale, batch, noise, *, cfg_s, tx_wm, tx_actor,
                    tx_critic, record=None):
    """World model + imagination actor-critic in one function
    (``ray_tpu/rllib/dreamer.py:152``), in place: ``params``,
    ``target_critic`` and the three optimizer states step; returns
    ``(ret_scale, metrics)``, the new return scale a 0-d tensor and the
    metrics of the update (detached tensors), as JAX's.

    batch rows are ARRIVAL-ALIGNED (the reference DreamerV3 layout):
    actions[t] is the action taken at t-1 that produced obs[t] (zero on
    episode starts), rewards[t] arrived WITH obs[t], cont[t] is 0 iff
    obs[t] is terminal. ``noise`` holds the Gumbel draws (module
    docstring); ``record`` (a list) receives each draw's indices and
    margins. cfg_s is the static size/coef tuple."""
    (n_actions, n_cats, n_classes, h_dim, horizon, gamma, lam,
     entropy_coef, free_nats, kl_dyn, kl_rep, tau) = cfg_s
    z_dim = n_cats * n_classes
    obs = symlog(batch["obs"])
    acts = F.one_hot(batch["actions"].long(), n_actions).to(obs.dtype)
    b, t = acts.shape[:2]
    is_first = batch["is_first"]

    # -- world model loss over the sequence (posterior filtering scan) --
    wm = params["wm"]
    embed = _mlp(wm["encoder"], obs)                          # [B,T,E]
    h = torch.zeros((b, h_dim), device=obs.device)
    z = torch.zeros((b, z_dim), device=obs.device)
    hs, zs, prior_l, post_l = [], [], [], []
    for i in range(t):
        # is_first: reset recurrent state AND the previous action
        keep = (1.0 - is_first[:, i])[:, None]
        h = h * keep
        z = z * keep
        a_prev = acts[:, i] * keep
        # actions[t] already IS the action arriving at t (see docstring)
        h = _gru(wm["gru"], torch.cat([z, a_prev], -1), h)
        prior_lg = _mlp(wm["prior"], h)
        post_lg = _mlp(wm["post"], torch.cat([h, embed[:, i]], -1))
        z = _sample_onehot(post_lg, noise["post"][i], n_cats, n_classes,
                           record=record)
        hs.append(h)
        zs.append(z)
        prior_l.append(prior_lg)
        post_l.append(post_lg)
    hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)           # [B,T,...]
    prior_lg, post_lg = torch.stack(prior_l, 1), torch.stack(post_l, 1)
    feat = torch.cat([hs, zs], -1)                            # [B,T,F]

    recon = _mlp(wm["decoder"], feat)
    rew_pred = _mlp(wm["reward"], feat)[..., 0]
    cont_pred = _mlp(wm["cont"], feat)[..., 0]                # logits
    recon_loss = torch.mean(torch.sum((recon - obs) ** 2, -1))
    # fresh-reset rows have no arriving transition: mask their
    # reward/continue targets (their stored values are placeholders)
    m = 1.0 - is_first
    denom = torch.clamp(torch.sum(m), min=1.0)
    rew_loss = torch.sum(
        m * (rew_pred - symlog(batch["rewards"])) ** 2) / denom
    cont_loss = torch.sum(m * _sigmoid_bce(cont_pred, batch["cont"])) / denom
    # KL balancing with free bits (reference: dyn 0.5 / rep 0.1)
    kl_d = _kl_cats(post_lg.detach(), prior_lg, n_cats, n_classes)
    kl_r = _kl_cats(post_lg, prior_lg.detach(), n_cats, n_classes)
    kl_loss = (kl_dyn * torch.mean(torch.clamp(kl_d, min=free_nats))
               + kl_rep * torch.mean(torch.clamp(kl_r, min=free_nats)))
    wm_total = recon_loss + rew_loss + cont_loss + kl_loss
    adam_step(tx_wm, opt_wm, leaves(wm), wm_total)

    # -- imagination from every posterior state (updated world model) --
    wm_sg = _stopped(wm)
    target = _stopped(target_critic)
    n = b * t
    with torch.no_grad():
        h = hs.reshape(n, h_dim)
        z = zs.reshape(n, z_dim)
    feats, logps, ents = [], [], []
    for k in range(horizon):
        f = torch.cat([h, z], -1)
        lg = _mlp(params["actor"], f)
        a = _categorical(lg.detach(), noise["act"][k], record)
        logp_all = torch.log_softmax(lg, -1)
        logps.append(logp_all.gather(1, a[:, None])[:, 0])
        ents.append(-torch.sum(torch.softmax(lg, -1) * logp_all, -1))
        feats.append(f)
        with torch.no_grad():
            a1 = F.one_hot(a, n_actions).to(f.dtype)
            h = _gru(wm_sg["gru"], torch.cat([z, a1], -1), h)
            z = _sample_onehot(_mlp(wm_sg["prior"], h), noise["prior"][k],
                               n_cats, n_classes, record=record)
    feats_sg = torch.stack(feats)                             # [H,N,F]
    logps, ents = torch.stack(logps), torch.stack(ents)       # [H,N]
    f_last_sg = torch.cat([h, z], -1)

    with torch.no_grad():
        # arrival-aligned heads: the reward/continue of taking a_k at f_k
        # are predicted from the POST-transition features f_{k+1} (whose
        # GRU encodes a_k) — matching the world-model targets
        feats_next = torch.cat([feats_sg[1:], f_last_sg[None]], 0)
        rewards = symexp(_mlp(wm_sg["reward"], feats_next)[..., 0])
        conts = torch.sigmoid(_mlp(wm_sg["cont"], feats_next)[..., 0])
        disc = gamma * conts                                  # [H,N]
        # lambda-returns bootstrapped with the EMA target critic
        vs = symexp(_mlp(target, feats_sg)[..., 0])           # [H,N]
        v_last = symexp(_mlp(target, f_last_sg)[..., 0])
        v_next = torch.cat([vs[1:], v_last[None]], 0)
        returns = torch.empty_like(rewards)
        nxt = v_last
        for k in range(horizon - 1, -1, -1):                  # reversed
            nxt = rewards[k] + disc[k] * ((1.0 - lam) * v_next[k]
                                          + lam * nxt)
            returns[k] = nxt
        # percentile return normalization (EMA of the 5-95 range)
        flat = returns.reshape(-1)
        rng95 = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
        scale_new = 0.99 * ret_scale + 0.01 * torch.clamp(rng95, min=1.0)
        adv = (returns - vs) / scale_new
    # gradients flow only through logps/ents; returns and features serve
    # the critic update
    a_loss = -torch.mean(adv * logps) - entropy_coef * torch.mean(ents)
    adam_step(tx_actor, opt_actor, leaves(params["actor"]), a_loss)

    v_pred = _mlp(params["critic"], feats_sg)[..., 0]
    c_loss = torch.mean((v_pred - symlog(returns)) ** 2)
    adam_step(tx_critic, opt_critic, leaves(params["critic"]), c_loss)
    with torch.no_grad():
        for tgt, o in zip(leaves(target_critic), leaves(params["critic"]),
                          strict=True):
            tgt.copy_((1 - tau) * tgt + tau * o)

    metrics = {
        "wm_loss": wm_total,
        "recon_loss": recon_loss,
        "reward_loss": rew_loss,
        "cont_loss": cont_loss,
        "kl_loss": kl_loss,
        "actor_loss": a_loss,
        "critic_loss": c_loss,
        "imag_return_mean": torch.mean(returns),
        "policy_entropy": torch.mean(ents),
    }
    return scale_new, {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# sequence replay: one flat ring of steps, windows sampled anywhere —
# is_first flags let the posterior scan reset across episode joints
# ---------------------------------------------------------------------------

class SequenceReplay:
    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.is_first = np.zeros((capacity,), np.float32)
        self.cont = np.ones((capacity,), np.float32)
        self.pos = 0
        self.size = 0
        self._last_writer: int | None = None

    def add_batch(self, frag: dict, writer: int = 0):
        n = len(frag["actions"])
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = frag["obs"]
        self.actions[idx] = frag["actions"]
        self.rewards[idx] = frag["rewards"]
        self.is_first[idx] = frag["is_first"]
        self.cont[idx] = frag["cont"]
        # fragments from DIFFERENT workers interleave in the ring: a
        # sampled window crossing such a joint would stitch unrelated
        # trajectories, so the joint is forced to a sequence start (a
        # same-worker fragment continues its predecessor and keeps
        # cross-fragment state)
        if writer != self._last_writer:
            self.is_first[idx[0]] = 1.0
            self._last_writer = writer
        self.pos = int((self.pos + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)
        # the ring write head truncates whatever sequence it lands in:
        # mark the NEXT slot a sequence start so a sampled window never
        # stitches new steps onto stale ones
        if self.size == self.capacity:
            self.is_first[self.pos] = 1.0

    def sample(self, batch_size: int, seq_len: int, rng) -> dict:
        if self.size == self.capacity:
            # full ring: sample starts over the WHOLE ring modulo
            # capacity — windows spanning the capacity-1 -> 0 boundary
            # are temporally contiguous (the write head marks is_first
            # where continuity actually breaks), and excluding them
            # permanently under-samples the steps just after index 0
            starts = rng.integers(0, self.size, size=batch_size)
            idx = (starts[:, None] + np.arange(seq_len)[None, :]) \
                % self.capacity
        else:
            starts = rng.integers(0, self.size - seq_len + 1,
                                  size=batch_size)
            idx = starts[:, None] + np.arange(seq_len)[None, :]
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "is_first": self.is_first[idx],
            "cont": self.cont[idx],
        }


# ---------------------------------------------------------------------------
# rollout worker: numpy mirror of the filtering policy
# ---------------------------------------------------------------------------

class _DreamerRolloutWorker:
    def __init__(self, env_name: str, seed: int, sizes: tuple):
        self.env = make_env(env_name, seed=seed)
        self.rng = np.random.default_rng(seed)
        (self.n_actions, self.n_cats, self.n_classes,
         self.h_dim) = sizes
        self.obs = self.env.reset()
        self.first = True
        self.h = np.zeros((self.h_dim,), np.float32)
        self.z = np.zeros((self.n_cats * self.n_classes,), np.float32)
        self.prev_action = 0
        self.prev_reward = 0.0
        self.ep_ret = 0.0

    def sample(self, wm_np, actor_np, num_steps: int) -> dict:
        """Collect ``num_steps`` env steps as ARRIVAL-ALIGNED rows:
        row t = (obs_t, the action that produced obs_t, the reward that
        arrived with obs_t, is_first, cont). Episode ends additionally
        emit the terminal observation's row (cont=0 on termination, 1 on
        time-limit truncation), so terminal rewards are trainable."""
        obs_l, act_l, rew_l, first_l, cont_l = [], [], [], [], []
        episode_returns = []
        for _ in range(num_steps):
            if self.first:
                self.h[:] = 0.0
                self.z[:] = 0.0
                self.prev_action = 0
                self.prev_reward = 0.0
            # the row for the CURRENT (non-terminal) observation
            obs_l.append(self.obs)
            act_l.append(self.prev_action)
            rew_l.append(self.prev_reward)
            first_l.append(float(self.first))
            cont_l.append(1.0)
            # filtering policy: posterior over (h advanced by the
            # arriving action, current obs embedding). Episode-first
            # steps feed a ZERO action vector — matching the training
            # scan's `a_prev * keep` reset (a one-hot for action 0
            # would alias action 0 with episode starts)
            a_prev = np.zeros((self.n_actions,), np.float32)
            if not self.first:
                a_prev[self.prev_action] = 1.0
            obs_sym = _np_symlog(self.obs)
            e = _np_mlp(wm_np["encoder"], obs_sym.astype(np.float32))
            self.h = _np_gru(wm_np["gru"],
                             np.concatenate([self.z, a_prev]), self.h)
            post = _np_mlp(wm_np["post"], np.concatenate([self.h, e]))
            probs = _np_softmax(
                post.reshape(self.n_cats, self.n_classes))
            probs = 0.99 * probs + 0.01 / self.n_classes
            z = np.zeros_like(probs)
            for c in range(self.n_cats):
                z[c, self.rng.choice(self.n_classes, p=probs[c])] = 1.0
            self.z = z.reshape(-1).astype(np.float32)
            lg = _np_mlp(actor_np, np.concatenate([self.h, self.z]))
            a = int(self.rng.choice(self.n_actions, p=_np_softmax(lg)))
            next_obs, reward, done, _ = self.env.step(a)
            self.ep_ret += reward
            self.first = False
            if done:
                # terminal observation's row carries the final reward.
                # ``truncated`` is part of the env protocol (env.py sets
                # it on every builtin env): a time-limit end must train
                # the continue head as cont=1 (bootstrappable), not as a
                # true termination. Envs lacking the attribute get one
                # warning — silently treating their truncations as
                # terminations biases value bootstrapping.
                if not hasattr(self.env, "truncated") and \
                        not getattr(self, "_warned_truncated", False):
                    self._warned_truncated = True
                    import warnings

                    warnings.warn(
                        f"{type(self.env).__name__} does not expose "
                        f"'truncated'; episode ends will all be treated "
                        f"as true terminations (cont=0), which biases "
                        f"DreamerV3's continue head on time-limit envs",
                        stacklevel=2)
                terminal = not bool(getattr(self.env, "truncated",
                                            False))
                obs_l.append(next_obs)
                act_l.append(a)
                rew_l.append(reward)
                first_l.append(0.0)
                cont_l.append(0.0 if terminal else 1.0)
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.obs = self.env.reset()
                self.first = True
            else:
                self.prev_action = a
                self.prev_reward = reward
                self.obs = next_obs
        return {"obs": np.asarray(obs_l, np.float32),
                "actions": np.asarray(act_l, np.int32),
                "rewards": np.asarray(rew_l, np.float32),
                "is_first": np.asarray(first_l, np.float32),
                "cont": np.asarray(cont_l, np.float32),
                "episode_returns": episode_returns}


# ---------------------------------------------------------------------------
# config + algorithm
# ---------------------------------------------------------------------------

@dataclass
class DreamerV3Config:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 128
    seq_len: int = 16
    batch_size: int = 8
    horizon: int = 8
    lr_wm: float = 1e-3
    lr_actor: float = 3e-4
    lr_critic: float = 3e-4
    gamma: float = 0.997
    lam: float = 0.95
    entropy_coef: float = 3e-3
    free_nats: float = 1.0
    kl_dyn: float = 0.5
    kl_rep: float = 0.1
    tau: float = 0.02               # EMA target-critic rate
    embed: int = 64
    h_dim: int = 128
    n_cats: int = 8
    n_classes: int = 8
    hidden: int = 128
    buffer_capacity: int = 50_000
    learning_starts: int = 256
    num_updates_per_iter: int = 4
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env) -> "DreamerV3Config":
        return replace(self, env=env)

    def rollouts(self, **kw) -> "DreamerV3Config":
        return replace(self, **kw)

    def training(self, **kw) -> "DreamerV3Config":
        return replace(self, **kw)

    def build(self) -> "DreamerV3":
        return DreamerV3(self)


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` of uniforms in
    [tiny, 1)."""
    u = torch.rand(shape, generator=gen).clamp_(
        min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class DreamerV3:
    """``train()`` also reports its seconds split into sampling and
    learning (``sample_time_s``, ``learn_time_s``)."""

    def __init__(self, config: DreamerV3Config):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        if getattr(env, "continuous", False):
            raise ValueError("this DreamerV3 build is discrete-action "
                             f"only; got continuous env {config.env!r}")
        self.obs_dim = env.obs_dim
        self.n_actions = env.n_actions
        c = config
        self.params = init_dreamer(
            c.seed, self.obs_dim, self.n_actions, embed=c.embed,
            h_dim=c.h_dim, n_cats=c.n_cats, n_classes=c.n_classes,
            hidden=c.hidden, device=self.device)
        self.target_critic = frozen_tree(self.params["critic"])
        self.tx_wm = AdamW(partial(_constant, c.lr_wm), max_grad_norm=100.0,
                           b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        self.tx_actor = adam(c.lr_actor)
        self.tx_critic = adam(c.lr_critic)
        self.opt_wm = init_opt_state(self.tx_wm, leaves(self.params["wm"]))
        self.opt_actor = init_opt_state(self.tx_actor,
                                        leaves(self.params["actor"]))
        self.opt_critic = init_opt_state(self.tx_critic,
                                         leaves(self.params["critic"]))
        self.ret_scale = torch.ones((), device=self.device)
        self.buffer = SequenceReplay(c.buffer_capacity, self.obs_dim)
        self.rng = np.random.default_rng(c.seed)
        self.noise_gen = torch.Generator().manual_seed(c.seed + 1)
        self.iteration = 0
        cfg_s = (self.n_actions, c.n_cats, c.n_classes, c.h_dim,
                 c.horizon, c.gamma, c.lam, c.entropy_coef, c.free_nats,
                 c.kl_dyn, c.kl_rep, c.tau)
        self._update = partial(
            _dreamer_update, cfg_s=cfg_s, tx_wm=self.tx_wm,
            tx_actor=self.tx_actor, tx_critic=self.tx_critic)
        sizes = (self.n_actions, c.n_cats, c.n_classes, c.h_dim)
        self.workers = [
            _DreamerRolloutWorker(c.env, c.seed + 1000 * (i + 1), sizes)
            for i in range(c.num_rollout_workers)
        ]

    def _noise(self) -> dict:
        """One update's Gumbel draws (module docstring) as numpy."""
        c = self.config
        n = c.batch_size * c.seq_len
        return {"post": _gumbel(self.noise_gen, (
                    c.seq_len, c.batch_size, c.n_cats, c.n_classes)).numpy(),
                "act": _gumbel(self.noise_gen, (
                    c.horizon, n, self.n_actions)).numpy(),
                "prior": _gumbel(self.noise_gen, (
                    c.horizon, n, c.n_cats, c.n_classes)).numpy()}

    def _policy_np(self):
        wm = self.params["wm"]
        wm_np = numpy_tree({k: wm[k] for k in ("encoder", "gru", "post")})
        return wm_np, numpy_tree(self.params["actor"])

    def update(self, batch: dict, noise: dict) -> dict:
        """One ``_dreamer_update`` on a numpy batch and numpy noise, in
        place; returns its metrics as floats."""
        self.ret_scale, metrics = self._update(
            self.params, self.target_critic, self.opt_wm, self.opt_actor,
            self.opt_critic, self.ret_scale, to_device(batch, self.device),
            to_device(noise, self.device))
        return dict(zip(metrics, torch.stack(list(metrics.values()))
                        .tolist()))

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        wm_np, actor_np = self._policy_np()
        frags = [w.sample(wm_np, actor_np, cfg.rollout_fragment_length)
                 for w in self.workers]
        episode_returns = []
        for i, f in enumerate(frags):
            episode_returns.extend(f.pop("episode_returns"))
            self.buffer.add_batch(f, writer=i)
        t1 = time.perf_counter()

        metrics = {}
        if self.buffer.size >= max(cfg.learning_starts,
                                   cfg.seq_len + 1):
            for _ in range(cfg.num_updates_per_iter):
                batch = self.buffer.sample(cfg.batch_size, cfg.seq_len,
                                           self.rng)
                metrics = self.update(batch, self._noise())
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

    def compute_single_action(self, obs, state=None):
        """Greedy filtered action; pass/carry ``state`` (h, z, a_prev)
        across steps of one episode (None = episode start)."""
        wm_np, actor_np = self._policy_np()
        c = self.config
        if state is None:
            h = np.zeros((c.h_dim,), np.float32)
            z = np.zeros((c.n_cats * c.n_classes,), np.float32)
            a_prev = np.zeros((self.n_actions,), np.float32)
        else:
            h, z, a_prev = state
        e = _np_mlp(wm_np["encoder"],
                    np.asarray(_np_symlog(np.asarray(obs)), np.float32))
        h = _np_gru(wm_np["gru"], np.concatenate([z, a_prev]), h)
        post = _np_mlp(wm_np["post"], np.concatenate([h, e]))
        probs = _np_softmax(post.reshape(c.n_cats, c.n_classes))
        z = np.zeros_like(probs)
        z[np.arange(c.n_cats), probs.argmax(-1)] = 1.0
        z = z.reshape(-1).astype(np.float32)
        lg = _np_mlp(actor_np, np.concatenate([h, z]))
        a = int(np.argmax(lg))
        a1 = np.zeros((self.n_actions,), np.float32)
        a1[a] = 1.0
        return a, (h, z, a1)

    def stop(self):
        pass
