"""Connector pipelines: obs/action transformations between env and policy.

Port of ``ray_tpu/rllib/connectors.py``, which is numpy only: this is its
copy, ``ConnectorEnv`` resolving names through the port's ``make_env``.
Reference analog: ``rllib/connectors/`` — env-to-module connectors
preprocess observations on the way INTO the policy (flatten, running
normalization, frame stacking) and module-to-env connectors postprocess
actions on the way OUT (clip, unsquash). Pipelines are stateful (running
stats, stacked frames), serializable (``state_dict``/``load_state``) so
learned preprocessing travels with checkpoints, and composable.

``ConnectorEnv`` wraps any registry/gymnasium env with a pipeline pair,
so every algorithm gains connectors through its existing ``env`` config
field: ``PPOConfig(env=lambda seed=None: ConnectorEnv("CartPole",
obs_connectors=[NormalizeObs()], seed=seed))``.
"""

from __future__ import annotations

import numpy as np


class Connector:
    """One transformation stage. Override ``__call__``; optionally
    ``state_dict``/``load_state`` for learned/stateful stages and
    ``reset`` for per-episode state."""

    def __call__(self, x):
        raise NotImplementedError

    def reset(self):
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state(self, state: dict):
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: list[Connector] | None = None):
        self.connectors = list(connectors or [])

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self):
        for c in self.connectors:
            c.reset()

    def state_dict(self) -> dict:
        return {str(i): c.state_dict()
                for i, c in enumerate(self.connectors)}

    def load_state(self, state: dict):
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.load_state(state[str(i)])


# ---------------------------------------------------------------------------
# env-to-module (observation) connectors
# ---------------------------------------------------------------------------

class FlattenObs(Connector):
    """Any-shaped observation -> 1-D float32 vector (reference:
    ``connectors/env_to_module/flatten_observations.py``)."""

    def __call__(self, obs):
        return np.asarray(obs, np.float32).reshape(-1)


class NormalizeObs(Connector):
    """Running mean/std normalization (reference:
    ``mean_std_filter.py`` — the classic MeanStdFilter). Welford
    accumulation; stats persist via state_dict."""

    def __init__(self, clip: float = 10.0, epsilon: float = 1e-8):
        self.clip = clip
        self.epsilon = epsilon
        self.count = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None
        self.frozen = False   # eval mode: apply stats, stop updating

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(obs)
            self.m2 = np.zeros_like(obs)
        if not self.frozen:
            self.count += 1
            delta = obs - self.mean
            self.mean = self.mean + delta / self.count
            self.m2 = self.m2 + delta * (obs - self.mean)
        var = (self.m2 / max(self.count - 1, 1)
               if self.count > 1 else np.ones_like(obs))
        out = (obs - self.mean) / np.sqrt(var + self.epsilon)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.copy(),
                "m2": None if self.m2 is None else self.m2.copy()}

    def load_state(self, state: dict):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class FrameStack(Connector):
    """Stack the last k observations along a new leading axis
    (reference: ``frame_stacking.py``). reset() clears the deque at
    episode boundaries; short episodes left-pad with the first frame."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: list = []

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if not self._frames:
            self._frames = [obs] * self.k
        else:
            self._frames = self._frames[1:] + [obs]
        return np.stack(self._frames)

    def reset(self):
        self._frames = []


# ---------------------------------------------------------------------------
# module-to-env (action) connectors
# ---------------------------------------------------------------------------

class ClipActions(Connector):
    """Clip continuous actions into [low, high] (reference:
    ``module_to_env/clip_actions`` option)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action):
        return np.clip(np.asarray(action, np.float32),
                       self.low, self.high)


class UnsquashActions(Connector):
    """Map tanh-space actions in [-1, 1] to [low, high] (reference:
    ``normalize_actions``/unsquash option)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action):
        a = np.asarray(action, np.float32)
        return self.low + (np.clip(a, -1.0, 1.0) + 1.0) * 0.5 \
            * (self.high - self.low)


# ---------------------------------------------------------------------------
# env wrapper
# ---------------------------------------------------------------------------

class ConnectorEnv:
    """Wrap an env with obs/action connector pipelines; algorithms use
    it through their ``env`` field (any callable accepting ``seed=``)."""

    def __init__(self, env_or_name, *, obs_connectors=None,
                 action_connectors=None, seed=None):
        from ray_tpu_torch.rllib.env import make_env

        # a CLASS has a .step attribute too — only an INSTANCE is used
        # as-is; names/classes/factories go through make_env
        if (isinstance(env_or_name, (str, type))
                or not hasattr(env_or_name, "step")):
            self.env = make_env(env_or_name, seed=seed)
        else:
            self.env = env_or_name
        self.obs_pipeline = ConnectorPipeline(obs_connectors)
        self.action_pipeline = ConnectorPipeline(action_connectors)

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self):
        self.obs_pipeline.reset()
        self.action_pipeline.reset()
        return self.obs_pipeline(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(
            self.action_pipeline(action))
        return self.obs_pipeline(obs), reward, done, info

    def state_dict(self) -> dict:
        return {"obs": self.obs_pipeline.state_dict(),
                "action": self.action_pipeline.state_dict()}

    def load_state(self, state: dict):
        self.obs_pipeline.load_state(state.get("obs", {}))
        self.action_pipeline.load_state(state.get("action", {}))
