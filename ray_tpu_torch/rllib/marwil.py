"""MARWIL — Monotonic Advantage Re-Weighted Imitation Learning.

Port of ``ray_tpu/rllib/marwil.py`` (reference analog:
``rllib/algorithms/marwil/marwil.py``): fit a value function on
Monte-Carlo returns, then weight the behavior-cloning log-likelihood by
``exp(beta * advantage)`` so better-than-average transitions are imitated
harder. ``beta = 0`` degenerates to plain BC. It reads ``offline.py``'s
dataset through ``estimators.episodes_from_dataset``.

The update steps the PPO-style module on the card (``device``, default
"cuda") unless the config asks for the CPU. The normaliser of the
exponent, ``sqd_adv_norm``, is a moving average kept on the host from the
batch's mean squared advantage read back each iteration, as JAX's.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.dqn import adam_step, to_device
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.estimators import episodes_from_dataset
from ray_tpu_torch.rllib.offline import OfflineDataset
from ray_tpu_torch.rllib.ppo import _np_forward, adam, init_module, logp_of


@dataclass
class MARWILConfig:
    env: str = "CartPole-v1"
    input_path: str = ""
    lr: float = 1e-3
    beta: float = 1.0               # advantage-weighting temperature
    vf_coeff: float = 1.0
    gamma: float = 0.99
    batch_size: int = 256
    hidden: int = 64
    # moving average of squared advantage used to normalize the
    # exponent (the reference's ``moving_average_sqd_adv_norm``)
    adv_norm_decay: float = 0.99
    seed: int = 0
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env):
        return replace(self, env=env)

    def offline_data(self, input_path: str):
        return replace(self, input_path=input_path)

    def training(self, **kw):
        return replace(self, **kw)

    def build(self):
        return MARWIL(self)


class MARWIL:
    def __init__(self, config: MARWILConfig):
        self.config = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, seed=config.seed)
        self.env = env
        self.params = init_module(config.seed, env.obs_dim, env.n_actions,
                                  config.hidden, device=self.device)
        self.tx = adam(config.lr)
        self.opt_state = self.tx.init(dict(self.params.named_parameters()))
        self.iteration = 0
        self.rng = np.random.default_rng(config.seed)
        self._sqd_adv_norm = 1.0

        ds = OfflineDataset(config.input_path)
        # Monte-Carlo returns per episode (the regression target for the
        # value head and the advantage source for the policy weight)
        obs, actions, returns = [], [], []
        for ep in episodes_from_dataset(ds):
            g = 0.0
            rets = np.zeros(len(ep["rewards"]))
            for t in range(len(ep["rewards"]) - 1, -1, -1):
                g = ep["rewards"][t] + config.gamma * g
                rets[t] = g
            obs.append(ep["obs"])
            actions.append(ep["actions"])
            returns.append(rets)
        self.data = {
            "obs": np.concatenate(obs).astype(np.float32),
            "actions": np.concatenate(actions).astype(np.int32),
            "returns": np.concatenate(returns).astype(np.float32),
        }
        self._update = partial(_marwil_update, tx=self.tx, beta=config.beta,
                               vf_coeff=config.vf_coeff)

    def train(self) -> dict:
        n = len(self.data["obs"])
        sel = self.rng.permutation(n)[:self.config.batch_size]
        batch = {k: v[sel] for k, v in self.data.items()}
        stats = self._update(self.params, self.opt_state,
                             to_device(batch, self.device),
                             sqd_adv_norm=self._sqd_adv_norm)
        stats = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        d = self.config.adv_norm_decay
        self._sqd_adv_norm = (d * self._sqd_adv_norm +
                              (1 - d) * stats["sqd_adv"])
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "policy_loss": stats["policy_loss"],
            "vf_loss": stats["vf_loss"],
            "mean_adv_weight": stats["mean_weight"],
            "num_samples_trained": len(batch["obs"]),
        }

    def compute_action(self, obs) -> int:
        logits, _ = _np_forward(self.params.numpy_tree(),
                                np.asarray(obs)[None])
        return int(np.argmax(logits[0]))

    def evaluate(self, num_episodes: int = 10) -> dict:
        rets = []
        for _ in range(num_episodes):
            obs, total, done = self.env.reset(), 0.0, False
            steps = 0
            while not done and steps < 500:
                obs, r, done, _ = self.env.step(self.compute_action(obs))
                total += r
                steps += 1
            rets.append(total)
        return {"episode_return_mean": float(np.mean(rets))}

    def save(self, path: str):
        """JAX's checkpoint format: a pickle of the numpy parameter tree."""
        with open(path, "wb") as f:
            pickle.dump(self.params.numpy_tree(), f)

    def restore(self, path: str):
        """Load a pickle of a numpy parameter tree (this port's or the JAX
        package's ``save``)."""
        from ray_tpu_torch import convert

        with open(path, "rb") as f:
            self.params = convert.policy_value_from_numpy(
                pickle.load(f), device=self.device)

    def stop(self):
        pass


def _marwil_update(params, opt_state, batch, *, sqd_adv_norm: float, tx,
                   beta, vf_coeff) -> dict:
    """MARWIL's step (``ray_tpu/rllib/marwil.py:148``), in place. Returns
    the stats as tensors: the losses, the mean weight and the batch's mean
    squared advantage (``sqd_adv``, which feeds the host's moving
    average)."""
    logits, values = params(batch["obs"])
    logp = logp_of(torch.log_softmax(logits, dim=-1), batch["actions"])
    adv = batch["returns"] - values
    # normalize the exponent by the running RMS of advantages so the
    # weights stay bounded as the value fit improves
    norm = torch.tensor(sqd_adv_norm, dtype=torch.float32,
                        device=adv.device)
    weight = torch.exp(beta * adv / torch.sqrt(norm + 1e-8))
    weight = torch.clamp(weight, max=20.0)  # explosion guard
    policy_loss = -torch.mean(weight.detach() * logp)
    vf_loss = torch.mean(adv ** 2)
    total = policy_loss + vf_coeff * vf_loss
    stats = {"policy_loss": policy_loss.detach(), "vf_loss": vf_loss.detach(),
             "mean_weight": torch.mean(weight).detach(),
             "sqd_adv": torch.mean(adv ** 2).detach()}
    adam_step(tx, opt_state, list(params.parameters()), total)
    return stats
