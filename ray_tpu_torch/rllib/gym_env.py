"""Gymnasium bridge: any ``gymnasium.Env`` plugs into the rollout/learner
stack. The port's own copy of ``ray_tpu/rllib/gym_env.py`` (reference:
``rllib/env/env_runner.py`` consuming gym-API envs; BASELINE config 5
names Atari/MuJoCo-class envs, which ship as gymnasium environments).

The framework's internal env protocol is 4-tuple classic-gym style
(``reset() -> obs``, ``step(a) -> (obs, reward, done, info)``) with
``obs_dim``/``n_actions`` (discrete) or ``action_dim``/``action_low``/
``action_high``/``continuous`` attributes — this adapter derives those
from gymnasium spaces and folds ``terminated|truncated`` into ``done``.
"""

from __future__ import annotations

import numpy as np


def _flat_dim(space) -> int:
    import gymnasium.spaces as sp

    if isinstance(space, sp.Box):
        return int(np.prod(space.shape))
    if isinstance(space, sp.Discrete):
        return int(space.n)
    raise ValueError(f"unsupported observation space {space!r}")


class GymEnvAdapter:
    """Wrap a gymnasium env (instance or id) into the internal env API.

    Observations are flattened to float32 vectors; Discrete observations
    become one-hot. Discrete action spaces expose ``n_actions``; Box
    action spaces expose ``action_dim``/bounds with ``continuous=True``.
    """

    def __init__(self, env_or_id, seed: int | None = None, **make_kwargs):
        import gymnasium as gym
        import gymnasium.spaces as sp

        if isinstance(env_or_id, str):
            self.env = gym.make(env_or_id, **make_kwargs)
        else:
            self.env = env_or_id
        self._seed = seed
        self._needs_seed = True
        obs_space = self.env.observation_space
        act_space = self.env.action_space
        self._discrete_obs = isinstance(obs_space, sp.Discrete)
        self.obs_dim = _flat_dim(obs_space)
        if isinstance(act_space, sp.Discrete):
            self.continuous = False
            self.n_actions = int(act_space.n)
        elif isinstance(act_space, sp.Box):
            self.continuous = True
            self.action_dim = int(np.prod(act_space.shape))
            self.action_low = float(np.min(act_space.low))
            self.action_high = float(np.max(act_space.high))
            self._act_shape = act_space.shape
            self._act_dtype = act_space.dtype
        else:
            raise ValueError(f"unsupported action space {act_space!r}")

    def _obs(self, raw):
        if self._discrete_obs:
            onehot = np.zeros(self.obs_dim, dtype=np.float32)
            onehot[int(raw)] = 1.0
            return onehot
        return np.asarray(raw, dtype=np.float32).reshape(-1)

    def reset(self):
        # seed exactly once at first reset (gymnasium seeding protocol);
        # later resets continue the env's own rng stream
        if self._needs_seed and self._seed is not None:
            raw, _ = self.env.reset(seed=int(self._seed))
            self._needs_seed = False
        else:
            raw, _ = self.env.reset()
        return self._obs(raw)

    def step(self, action):
        if self.continuous:
            act = np.asarray(action, dtype=self._act_dtype).reshape(
                self._act_shape)
        else:
            act = int(np.asarray(action).reshape(-1)[0])
        raw, reward, terminated, truncated, info = self.env.step(act)
        # exposed for consumers that must distinguish time-limit
        # truncation from termination (value bootstrapping)
        self.truncated = bool(truncated and not terminated)
        return (self._obs(raw), float(reward),
                bool(terminated or truncated), info)

    def close(self):
        self.env.close()


def try_make_gym_env(name: str, seed=None):
    """Resolve an unknown env name through gymnasium (used as the
    fallback in ``make_env``); returns None when gymnasium is absent or
    doesn't know the id."""
    try:
        import gymnasium as gym
    except ImportError:
        return None
    try:
        gym.spec(name)
    except Exception:  # noqa: BLE001 - unknown id
        return None
    return GymEnvAdapter(name, seed=seed)
