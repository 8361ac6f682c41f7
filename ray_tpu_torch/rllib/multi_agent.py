"""Multi-agent RL on PyTorch: env API, policy mapping, and multi-agent PPO.

Port of ``ray_tpu/rllib/multi_agent.py``. Reference analogs:
- ``MultiAgentEnv`` (``rllib/env/multi_agent_env.py:30``): dict-keyed
  reset/step — ``reset() -> {agent_id: obs}``, ``step({agent_id: action})
  -> (obs_dict, reward_dict, done_dict, info_dict)`` with the special
  ``"__all__"`` done key ending the episode for everyone.
- ``PolicyMap`` (``rllib/policy/policy_map.py:20``): policy_id -> policy
  state with an LRU capacity bound (least-recently-used states detach to
  disk so league-style setups with 100s of policies fit in memory).
- policy mapping in rollouts (``rllib/evaluation/rollout_worker.py``,
  ``policy_mapping_fn``): every agent's observation routes to the policy
  its id maps to; sample batches are collected PER POLICY.
- multi-agent PPO training (``rllib/algorithms/ppo``) with shared or
  independent policies.

The envs, ``PolicyMap``, ``MultiAgentReplay`` and the rollout worker are
the JAX package's numpy host code, copied. Each policy is a
``PolicyValueMLP`` with its own ``adam`` state and updates with the
port's ``ppo_loss`` (``learner_group.sgd_step``), so N policies are N
small updates on the card. The rollout workers run in this process with JAX's seeds
(``seed + 1000*(i+1)``): the mapping function reaches them as it is,
with no serialization. ``MultiAgentPPOConfig.device`` defaults to
"cuda".
"""

from __future__ import annotations

import pickle
import time
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.learner_group import sgd_step
from ray_tpu_torch.rllib.ppo import (
    _episode_mean,
    _gae,
    _np_forward,
    _sample_actions,
    _softmax_rows,
    adam,
    init_module,
    ppo_loss,
)

AGENT_DONE_ALL = "__all__"


# ---------------------------------------------------------------------------
# MultiAgentEnv API + builtin envs
# ---------------------------------------------------------------------------

class MultiAgentEnv:
    """Base class for environments hosting multiple independent agents
    (reference: ``rllib/env/multi_agent_env.py:30``).

    Contract:
    - ``agent_ids``: iterable of string agent ids.
    - ``reset() -> {agent_id: obs}`` for every agent acting first step.
    - ``step(action_dict) -> (obs, rewards, dones, infos)``, all dicts
      keyed by agent id; ``dones["__all__"]`` ends the episode for every
      agent. Agents absent from ``obs`` don't act next step.
    - ``obs_dims`` / ``n_actions_map``: per-agent obs sizes and action
      counts (dict or scalar applied to all agents).
    """

    agent_ids: tuple = ()

    def reset(self) -> dict:
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    # -- space helpers (scalar = uniform across agents) --
    def obs_dim_of(self, agent_id) -> int:
        dims = getattr(self, "obs_dims", None)
        if isinstance(dims, dict):
            return dims[agent_id]
        return int(dims)

    def n_actions_of(self, agent_id) -> int:
        acts = getattr(self, "n_actions_map", None)
        if isinstance(acts, dict):
            return acts[agent_id]
        return int(acts)


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles, one per agent (the reference's standard
    multi-agent debug env, ``rllib/examples/env/multi_agent.py``).
    Each agent's episode ends on its own pole falling; ``__all__`` when
    every agent is done."""

    def __init__(self, num_agents: int = 2, seed: int | None = None):
        from ray_tpu_torch.rllib.env import CartPole

        self.agent_ids = tuple(f"agent_{i}" for i in range(num_agents))
        self.envs = {a: CartPole(seed=None if seed is None else seed + i)
                     for i, a in enumerate(self.agent_ids)}
        self.obs_dims = 4
        self.n_actions_map = 2
        self._done: set = set()

    def reset(self) -> dict:
        self._done = set()
        return {a: e.reset() for a, e in self.envs.items()}

    def step(self, action_dict: dict):
        obs, rews, dones, infos = {}, {}, {}, {}
        for a, act in action_dict.items():
            if a in self._done:
                continue
            o, r, d, i = self.envs[a].step(int(act))
            rews[a] = r
            dones[a] = d
            infos[a] = i
            if d:
                self._done.add(a)
            else:
                obs[a] = o
        dones[AGENT_DONE_ALL] = len(self._done) == len(self.agent_ids)
        return obs, rews, dones, infos


class CoopMatchEnv(MultiAgentEnv):
    """Two-agent cooperative coordination game with a deterministic
    learning signal (the multi-agent analog of ``BanditEnv``): each
    agent sees ITS OWN context in {-1,+1}^2 (different per agent);
    the team earns 1.0 split evenly only when BOTH agents match the
    sign of their own context. Solvable only if per-agent observations
    reach the right policies — a policy-routing bug flatlines it."""

    def __init__(self, seed: int | None = None):
        self.agent_ids = ("a0", "a1")
        self.rng = np.random.default_rng(seed)
        self.obs_dims = 2
        self.n_actions_map = 2
        self._obs: dict = {}

    def reset(self) -> dict:
        self._obs = {
            a: self.rng.choice([-1.0, 1.0], size=2).astype(np.float32)
            for a in self.agent_ids
        }
        return dict(self._obs)

    def step(self, action_dict: dict):
        ok = all((self._obs[a][0] > 0) == (int(action_dict[a]) == 1)
                 for a in self.agent_ids)
        rew = {a: (0.5 if ok else 0.0) for a in self.agent_ids}
        obs = self.reset()
        dones = {a: True for a in self.agent_ids}
        dones[AGENT_DONE_ALL] = True
        return obs, rew, dones, {}


MULTI_ENV_REGISTRY = {
    "MultiAgentCartPole": MultiAgentCartPole,
    "CoopMatch-v0": CoopMatchEnv,
}


def make_multi_env(name_or_cls, seed=None, **kw):
    if isinstance(name_or_cls, str):
        cls = MULTI_ENV_REGISTRY[name_or_cls]
        return cls(seed=seed, **kw)
    return name_or_cls(seed=seed, **kw)


# ---------------------------------------------------------------------------
# PolicyMap
# ---------------------------------------------------------------------------

class PolicyMap:
    """policy_id -> policy state, LRU-bounded (reference:
    ``rllib/policy/policy_map.py:20`` — keeps ``capacity`` policies in
    memory, detaches the least recently used to disk so league-based
    setups with 100s of policies fit). A state is any picklable object or
    a module with ``numpy_tree()`` (``rllib.ppo.PolicyValueMLP``): a
    module spills as its numpy tree, JAX's file format, and comes back
    to its device as a module when it is read."""

    def __init__(self, capacity: int = 100, spill_dir: str | None = None):
        self.capacity = capacity
        self._mem: OrderedDict = OrderedDict()
        self._spill_dir = spill_dir
        self._spilled: dict[str, str] = {}
        # policy id -> the device of a spilled module
        self._devices: dict[str, torch.device] = {}

    def __setitem__(self, policy_id: str, state):
        self._mem[policy_id] = state
        self._mem.move_to_end(policy_id)
        self._maybe_spill()

    def __getitem__(self, policy_id: str):
        if policy_id in self._mem:
            self._mem.move_to_end(policy_id)
            return self._mem[policy_id]
        path = self._spilled.get(policy_id)
        if path is None:
            raise KeyError(policy_id)
        with open(path, "rb") as f:
            state = pickle.load(f)
        self._spilled.pop(policy_id)
        device = self._devices.pop(policy_id, None)
        if device is not None:
            from ray_tpu_torch import convert

            state = convert.policy_value_from_numpy(state, device=device)
        self[policy_id] = state   # back in memory (may spill another)
        return state

    def __contains__(self, policy_id: str) -> bool:
        return policy_id in self._mem or policy_id in self._spilled

    def __iter__(self):
        yield from self._mem
        yield from self._spilled

    def __len__(self):
        return len(self._mem) + len(self._spilled)

    def keys(self):
        return list(self)

    def _maybe_spill(self):
        import os
        import tempfile

        while len(self._mem) > self.capacity:
            pid, state = self._mem.popitem(last=False)   # LRU
            if self._spill_dir is None:
                self._spill_dir = tempfile.mkdtemp(prefix="policy_map_")
            os.makedirs(self._spill_dir, exist_ok=True)
            path = f"{self._spill_dir}/{pid}.pkl"
            if hasattr(state, "numpy_tree"):
                self._devices[pid] = next(state.parameters()).device
                state = state.numpy_tree()
            with open(path, "wb") as f:
                pickle.dump(state, f)
            self._spilled[pid] = path


# ---------------------------------------------------------------------------
# Multi-policy replay (off-policy algorithms)
# ---------------------------------------------------------------------------

class MultiAgentReplay:
    """Replay keyed by policy id (reference: ``MultiAgentReplayBuffer``,
    rllib/utils/replay_buffers/multi_agent_replay_buffer.py): each
    policy's transitions live in an independent ring; sampling draws a
    per-policy batch so off-policy updates never mix experience across
    policies."""

    def __init__(self, capacity_per_policy: int = 100_000, seed: int = 0):
        self.capacity = capacity_per_policy
        self.rng = np.random.default_rng(seed)
        self._buffers: dict[str, dict] = {}
        self._sizes: dict[str, int] = defaultdict(int)
        self._heads: dict[str, int] = defaultdict(int)

    def add(self, policy_id: str, transitions: dict):
        """``transitions``: dict of equal-length arrays (column store)."""
        n = len(next(iter(transitions.values())))
        buf = self._buffers.get(policy_id)
        if buf is None:
            buf = {k: np.zeros((self.capacity,) + np.asarray(v).shape[1:],
                               np.asarray(v).dtype)
                   for k, v in transitions.items()}
            self._buffers[policy_id] = buf
        head = self._heads[policy_id]
        idx = (head + np.arange(n)) % self.capacity
        for k, v in transitions.items():
            buf[k][idx] = v
        self._heads[policy_id] = (head + n) % self.capacity
        self._sizes[policy_id] = min(self.capacity,
                                     self._sizes[policy_id] + n)

    def sample(self, policy_id: str, batch_size: int) -> dict:
        size = self._sizes[policy_id]
        if size == 0:
            raise ValueError(f"no experience for policy {policy_id!r}")
        idx = self.rng.integers(0, size, batch_size)
        return {k: v[idx] for k, v in self._buffers[policy_id].items()}

    def size(self, policy_id: str) -> int:
        return self._sizes[policy_id]

    def policy_ids(self):
        return list(self._buffers)


# ---------------------------------------------------------------------------
# Multi-agent rollout worker
# ---------------------------------------------------------------------------

class _MultiAgentRolloutWorker:
    """Steps a MultiAgentEnv, routing each agent's observation through
    the policy its id maps to (reference: per-policy batch collection in
    ``rollout_worker.py``). Returns ``{policy_id: flat batch}`` with
    per-agent GAE computed over each agent's OWN trajectory."""

    def __init__(self, env_spec, mapping_src, seed: int, env_kw=None):
        self.env = make_multi_env(env_spec, seed=seed, **(env_kw or {}))
        self.mapping = (pickle.loads(mapping_src)
                        if isinstance(mapping_src, bytes) else mapping_src)
        self.rng = np.random.default_rng(seed)

    def sample(self, policies_np: dict, num_steps: int, gamma: float,
               lam: float) -> dict:
        env = self.env
        # per-(agent) open trajectory columns
        traj = defaultdict(lambda: defaultdict(list))
        done_frags: list = []    # (agent, policy_id, cols, last_value)
        episode_returns: list = []
        ep_ret = 0.0
        obs = env.reset()
        for _ in range(num_steps):
            # group agents by policy: ONE batched forward per policy per
            # step (the multi-agent analog of the vectorized runner)
            by_policy = defaultdict(list)
            for a, o in obs.items():
                by_policy[self.mapping(a)].append((a, o))
            actions = {}
            for pid, items in by_policy.items():
                batch = np.stack([o for _, o in items])
                logits, values = _np_forward(policies_np[pid], batch)
                probs = _softmax_rows(logits)
                acts = _sample_actions(self.rng, probs)
                for j, (a, o) in enumerate(items):
                    actions[a] = int(acts[j])
                    t = traj[a]
                    t["obs"].append(o)
                    t["actions"].append(int(acts[j]))
                    t["logp"].append(
                        float(np.log(probs[j, acts[j]] + 1e-8)))
                    t["values"].append(float(values[j]))
            next_obs, rews, dones, _ = env.step(actions)
            for a in actions:
                t = traj[a]
                r = float(rews.get(a, 0.0))
                t["rewards"].append(r)
                t["dones"].append(float(bool(dones.get(a, False))))
                ep_ret += r
            # close finished agent trajectories (terminal value 0)
            for a in list(traj):
                if dones.get(a, False) or dones.get(AGENT_DONE_ALL, False):
                    done_frags.append((a, self.mapping(a),
                                       traj.pop(a), 0.0))
            if dones.get(AGENT_DONE_ALL, False):
                episode_returns.append(ep_ret)
                ep_ret = 0.0
                next_obs = env.reset()
            obs = next_obs
        # bootstrap still-open trajectories with the policy value
        for a, t in traj.items():
            pid = self.mapping(a)
            o = obs.get(a)
            last_v = 0.0
            if o is not None:
                _, v = _np_forward(policies_np[pid], o[None])
                last_v = float(v[0])
            done_frags.append((a, pid, t, last_v))
        # per-policy flat batches with per-fragment GAE
        out: dict = {}
        for _, pid, t, last_v in done_frags:
            if not t["rewards"]:
                continue
            n = len(t["rewards"])
            adv, ret = _gae(np.asarray(t["rewards"]),
                            np.asarray(t["values"][:n]),
                            np.asarray(t["dones"]), last_v, gamma, lam)
            cols = out.setdefault(pid, defaultdict(list))
            cols["obs"].append(np.asarray(t["obs"][:n], np.float32))
            cols["actions"].append(np.asarray(t["actions"][:n], np.int32))
            cols["logp"].append(np.asarray(t["logp"][:n], np.float32))
            cols["advantages"].append(adv.astype(np.float32))
            cols["returns"].append(ret.astype(np.float32))
        return {
            "batches": {
                pid: {k: np.concatenate(v) for k, v in cols.items()}
                for pid, cols in out.items()
            },
            "episode_returns": episode_returns,
        }


# ---------------------------------------------------------------------------
# Multi-agent PPO
# ---------------------------------------------------------------------------

def _default_mapping(agent_id) -> str:
    return "default"


@dataclass
class MultiAgentPPOConfig:
    """Builder-style config (reference: ``AlgorithmConfig.multi_agent``,
    algorithm_config.py): ``policies`` declares the policy ids (None =
    one shared policy "default" for every agent); ``policy_mapping_fn``
    routes agent ids to policy ids."""

    env: object = "CoopMatch-v0"
    env_kw: dict = field(default_factory=dict)
    policies: tuple = ("default",)
    policy_mapping_fn: object = None       # (agent_id) -> policy_id
    num_rollout_workers: int = 1
    rollout_fragment_length: int = 128
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
    # the learner's device ("cpu" only when asked for)
    device: str = "cuda"

    def environment(self, env, **env_kw) -> "MultiAgentPPOConfig":
        return replace(self, env=env, env_kw=env_kw)

    def multi_agent(self, *, policies=None, policy_mapping_fn=None
                    ) -> "MultiAgentPPOConfig":
        cfg = self
        if policies is not None:
            cfg = replace(cfg, policies=tuple(policies))
        if policy_mapping_fn is not None:
            cfg = replace(cfg, policy_mapping_fn=policy_mapping_fn)
        return cfg

    def rollouts(self, *, num_rollout_workers=None,
                 rollout_fragment_length=None) -> "MultiAgentPPOConfig":
        cfg = self
        if num_rollout_workers is not None:
            cfg = replace(cfg, num_rollout_workers=num_rollout_workers)
        if rollout_fragment_length is not None:
            cfg = replace(cfg,
                          rollout_fragment_length=rollout_fragment_length)
        return cfg

    def training(self, **kw) -> "MultiAgentPPOConfig":
        return replace(self, **kw)

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """PPO over a policy map: shared (every agent -> one policy) or
    independent (agent -> own policy) training. Each policy holds its
    own module and Adam state and updates with the same step as
    single-agent PPO — per-policy minibatches never mix. The k-th policy
    of ``config.policies`` starts from ``init_module(seed + k)``.
    ``train()`` also reports its seconds split into sampling and
    learning."""

    def __init__(self, config: MultiAgentPPOConfig):
        self.config = config
        self.device = resolve_device(config.device)
        probe = make_multi_env(config.env, seed=config.seed,
                               **config.env_kw)
        mapping = config.policy_mapping_fn or _default_mapping
        # validate the mapping covers every agent with a known policy
        for a in probe.agent_ids:
            pid = mapping(a)
            if pid not in config.policies:
                raise ValueError(
                    f"policy_mapping_fn({a!r}) = {pid!r} not in "
                    f"policies {config.policies}")
        self.mapping = mapping
        self.tx = adam(config.lr)
        self.policies = PolicyMap()
        self.opt_states: dict = {}
        for k, pid in enumerate(config.policies):
            # spaces come from any agent mapped to this policy
            agents = [a for a in probe.agent_ids if mapping(a) == pid]
            if not agents:
                raise ValueError(f"policy {pid!r} has no mapped agents")
            module = init_module(config.seed + k,
                                 probe.obs_dim_of(agents[0]),
                                 probe.n_actions_of(agents[0]),
                                 config.hidden, device=self.device)
            self.policies[pid] = module
            self.opt_states[pid] = self.tx.init(
                dict(module.named_parameters()))
        # JAX's ``_ppo_update`` for every policy: ``ppo_loss``'s gradients,
        # then one step of the policy's own Adam state (``sgd_step``)
        self._loss = partial(ppo_loss, clip_eps=config.clip_eps,
                             entropy_coeff=config.entropy_coeff,
                             vf_coeff=config.vf_coeff)
        self.workers = [
            _MultiAgentRolloutWorker(config.env, mapping,
                                     config.seed + 1000 * (i + 1),
                                     config.env_kw)
            for i in range(config.num_rollout_workers)
        ]
        self.iteration = 0

    def _policies_np(self) -> dict:
        return {pid: self.policies[pid].numpy_tree()
                for pid in self.policies.keys()}

    def train(self) -> dict:
        from ray_tpu_torch.rllib.dqn import to_device

        cfg = self.config
        t0 = time.perf_counter()
        policies_np = self._policies_np()
        results = [w.sample(policies_np, cfg.rollout_fragment_length,
                            cfg.gamma, cfg.lam) for w in self.workers]
        episode_returns = [r for res in results
                           for r in res["episode_returns"]]
        # merge per-policy batches across workers
        merged: dict = {}
        for res in results:
            for pid, b in res["batches"].items():
                cols = merged.setdefault(pid, defaultdict(list))
                for k, v in b.items():
                    cols[k].append(v)
        t1 = time.perf_counter()
        stats_acc: list = []
        rng = np.random.default_rng(cfg.seed + self.iteration)
        total_steps = 0
        for pid, cols in merged.items():
            batch = {k: np.concatenate(v) for k, v in cols.items()}
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            n = len(batch["obs"])
            total_steps += n
            module = self.policies[pid]
            opt_state = self.opt_states[pid]
            for _ in range(cfg.num_sgd_iter):
                perm = rng.permutation(n)
                for start in range(0, n, cfg.minibatch_size):
                    idx = perm[start:start + cfg.minibatch_size]
                    mb = to_device({k: v[idx] for k, v in batch.items()},
                                   self.device)
                    stats_acc.append(sgd_step(self._loss, module, opt_state,
                                              mb, self.tx))
        self.iteration += 1
        host = [dict(zip(s, torch.stack(list(s.values())).tolist()))
                for s in stats_acc]
        mean = lambda key: float(np.mean(  # noqa: E731
            [s[key] for s in host])) if host else 0.0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": _episode_mean(episode_returns),
            "num_episodes": len(episode_returns),
            "policy_loss": mean("policy_loss"),
            "entropy": mean("entropy"),
            "num_env_steps_sampled": total_steps,
            "policy_ids": sorted(merged),
            "sample_time_s": t1 - t0,
            "learn_time_s": time.perf_counter() - t1,
        }

    def compute_actions(self, obs_dict: dict) -> dict:
        policies_np = self._policies_np()
        out = {}
        for a, o in obs_dict.items():
            logits, _ = _np_forward(policies_np[self.mapping(a)],
                                    np.asarray(o)[None])
            out[a] = int(np.argmax(logits[0]))
        return out

    def save(self, path: str):
        """JAX's checkpoint format: a pickle of ``{policy_id: numpy
        tree}``."""
        with open(path, "wb") as f:
            pickle.dump(self._policies_np(), f)

    def restore(self, path: str):
        """Load a pickle of ``{policy_id: numpy tree}`` (this port's or
        the JAX package's ``save``); each policy keeps its Adam state, as
        JAX's does."""
        from ray_tpu_torch import convert

        with open(path, "rb") as f:
            state = pickle.load(f)
        for pid, params in state.items():
            self.policies[pid] = convert.policy_value_from_numpy(
                params, device=self.device)

    def stop(self):
        pass
