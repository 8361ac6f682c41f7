"""Environment API + builtin envs.

The port's own copy of ``ray_tpu/rllib/env.py`` (numpy only; the port
imports no module of ``ray_tpu``). Reference analog:
``rllib/env/env_runner.py:9`` ``EnvRunner`` environments (gym API).
Numpy-only (no gym dependency): ``reset() -> obs``,
``step(action) -> (obs, reward, done, info)``.
"""

from __future__ import annotations

import numpy as np


class CartPole:
    """Classic control CartPole-v1 dynamics (numpy re-implementation of
    the standard equations; episode cap 500)."""

    obs_dim = 4
    n_actions = 2

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.max_steps = 500
        self.state = None
        self.steps = 0

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.steps = 0
        self.truncated = False
        return self.state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.steps += 1
        failed = bool(abs(x) > self.x_threshold
                      or abs(theta) > self.theta_threshold)
        done = failed or self.steps >= self.max_steps
        # time-limit ends are TRUNCATIONS, not terminations — consumers
        # that bootstrap values past episode ends (DreamerV3's continue
        # head) must distinguish the two
        self.truncated = bool(done and not failed)
        return self.state.astype(np.float32), 1.0, done, {}


class BanditEnv:
    """One-step contextual bandit (deterministic learning signal for
    tests): obs in {-1,+1}^dim; action matching sign of obs[0] pays 1."""

    obs_dim = 2
    n_actions = 2

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)
        self.obs = None

    def reset(self):
        self.obs = self.rng.choice([-1.0, 1.0], size=2).astype(np.float32)
        return self.obs

    def step(self, action: int):
        reward = 1.0 if (self.obs[0] > 0) == (action == 1) else 0.0
        obs = self.reset()
        return obs, reward, True, {}


class Pendulum:
    """Classic control Pendulum-v1 dynamics (continuous torque in
    [-2, 2]; reward is negative cost of angle/velocity/effort)."""

    obs_dim = 3
    action_dim = 1
    action_low = -2.0
    action_high = 2.0
    continuous = True

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)
        self.max_speed = 8.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.length = 1.0
        self.max_steps = 200
        self.state = None
        self.steps = 0

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def reset(self):
        self.state = self.rng.uniform([-np.pi, -1.0], [np.pi, 1.0])
        self.steps = 0
        return self._obs()

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (3 * self.g / (2 * self.length) * np.sin(th)
                         + 3.0 / (self.m * self.length**2) * u) * self.dt
        thdot = float(np.clip(thdot, -self.max_speed, self.max_speed))
        th = th + thdot * self.dt
        self.state = np.array([th, thdot])
        self.steps += 1
        done = self.steps >= self.max_steps
        return self._obs(), -float(cost), done, {}


class ContinuousBandit:
    """One-step continuous-action env with a deterministic optimum
    (reward = -(a - 0.5)^2): fast, non-flaky learning signal for
    continuous-control tests."""

    obs_dim = 1
    action_dim = 1
    action_low = -1.0
    action_high = 1.0
    continuous = True
    target = 0.5

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)

    def reset(self):
        return np.zeros(1, dtype=np.float32)

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        reward = -(a - self.target) ** 2
        return self.reset(), reward, True, {}


class PixelCartPole:
    """CartPole with Atari-shaped observations: the 4-dim state is
    rendered into an 84x84 uint8 frame (cart position / pole angle
    drawn as bright bars — the policy must read the picture). The
    large-obs env for rollout/learner THROUGHPUT measurement
    (reference: the Atari suites in release_tests.yaml) without
    shipping ROMs."""

    obs_dim = 84 * 84
    n_actions = 2

    def __init__(self, seed: int | None = None):
        self.env = CartPole(seed=seed)

    def _render(self, state) -> np.ndarray:
        x, x_dot, theta, theta_dot = state
        frame = np.zeros((84, 84), np.float32)
        cart_col = int(np.clip((x / 2.4 + 1.0) * 41.5, 0, 83))
        frame[70:74, max(cart_col - 4, 0):cart_col + 5] = 1.0
        tip_col = int(np.clip(cart_col + 30 * np.sin(theta), 0, 83))
        tip_row = int(np.clip(70 - 30 * np.cos(theta), 0, 83))
        rr = np.linspace(70, tip_row, 30).astype(int)
        cc = np.linspace(cart_col, tip_col, 30).astype(int)
        frame[rr, cc] = 1.0
        # velocity channels as intensity rows (keeps it an MDP)
        frame[0, :] = np.clip(x_dot / 3.0 + 0.5, 0, 1)
        frame[1, :] = np.clip(theta_dot / 3.0 + 0.5, 0, 1)
        return frame.reshape(-1)

    def reset(self):
        return self._render(self.env.reset())

    def step(self, action):
        obs, r, d, i = self.env.step(action)
        self.truncated = self.env.truncated
        return self._render(obs), r, d, i


ENV_REGISTRY = {"CartPole-v1": CartPole, "Bandit-v0": BanditEnv,
                "Pendulum-v1": Pendulum,
                "ContinuousBandit-v0": ContinuousBandit,
                "PixelCartPole-v0": PixelCartPole}


def make_env(name_or_cls, seed=None):
    if isinstance(name_or_cls, str):
        cls = ENV_REGISTRY.get(name_or_cls)
        if cls is not None:
            return cls(seed=seed)
        # unknown id: resolve through gymnasium (Atari/MuJoCo-class envs)
        from ray_tpu_torch.rllib.gym_env import try_make_gym_env

        env = try_make_gym_env(name_or_cls, seed=seed)
        if env is None:
            raise KeyError(
                f"unknown env {name_or_cls!r}: not in ENV_REGISTRY and "
                f"not a gymnasium id")
        return env
    return name_or_cls(seed=seed)
