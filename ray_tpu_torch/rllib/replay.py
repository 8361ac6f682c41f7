"""Replay-buffer components: prioritized replay and n-step returns.

Port of ``ray_tpu/rllib/replay.py``, numpy copied verbatim, so a batch
and a generator give the same draws bit for bit in both packages.

Reference analogs: ``rllib/utils/replay_buffers/prioritized_replay_buffer.py``
(proportional prioritization on a segment tree, importance-sampling
weights with beta annealing — Schaul et al. 2015) and the n-step
return folding RLlib applies before insertion (``n_step`` in DQN-family
configs). Host-side numpy, like the reference keeps replay on CPU: it
is bandwidth-light bookkeeping feeding the TD update on the card.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.dqn import ReplayBuffer


class SumTree:
    """Flat-array binary segment tree over ``capacity`` priorities.

    ``prefix_search(masses)`` is vectorized: all queries descend the
    tree together, one level per iteration (O(batch * log n))."""

    def __init__(self, capacity: int):
        self.capacity = 1
        while self.capacity < capacity:
            self.capacity *= 2
        self.tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx: np.ndarray, priority: np.ndarray):
        """Set leaf priorities and repair the path to the root."""
        idx = np.asarray(idx, np.int64)
        if idx.size == 0:
            return
        pos = idx + self.capacity
        self.tree[pos] = priority
        pos //= 2
        while pos[0] >= 1:
            # recompute parents from children (dedup keeps it correct
            # when two updated leaves share a parent)
            pos = np.unique(pos)
            self.tree[pos] = self.tree[2 * pos] + self.tree[2 * pos + 1]
            pos //= 2
            if pos[0] == 0:
                break

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def prefix_search(self, masses: np.ndarray) -> np.ndarray:
        """For each mass m in [0, total), find the leaf where the
        running prefix sum crosses m."""
        idx = np.ones(len(masses), np.int64)
        m = np.asarray(masses, np.float64).copy()
        while idx[0] < self.capacity:
            left = self.tree[2 * idx]
            go_right = m >= left
            m = np.where(go_right, m - left, m)
            idx = 2 * idx + go_right
        return idx - self.capacity


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay: P(i) ∝ priority_i^alpha, with
    IS weights w_i = (N * P(i))^-beta normalized by max w. Storage and
    the ring-insert live in the uniform ``ReplayBuffer``; this subclass
    adds only the sum-tree priority bookkeeping."""

    def __init__(self, capacity: int, obs_dim: int, *,
                 alpha: float = 0.6, action_shape: tuple = (),
                 action_dtype=np.int32, eps: float = 1e-6,
                 gamma: float = 0.99):
        super().__init__(capacity, obs_dim, action_shape=action_shape,
                         action_dtype=action_dtype, gamma=gamma)
        self.alpha = alpha
        self.eps = eps
        self._tree = SumTree(capacity)
        self._max_priority = 1.0

    def add_batch(self, batch: dict):
        pos_before = self.pos
        super().add_batch(batch)
        n = min(len(batch["obs"]), self.capacity)
        idx = (pos_before + np.arange(n)) % self.capacity
        # new samples enter at max priority so everything is seen once
        self._tree.set(idx, np.full(n, self._max_priority ** self.alpha))

    def sample(self, batch_size: int, rng, *, beta: float = 0.4) -> dict:
        total = self._tree.total
        # stratified masses: one uniform draw per equal segment
        bounds = np.linspace(0.0, total, batch_size + 1)
        masses = rng.uniform(bounds[:-1], bounds[1:])
        idx = self._tree.prefix_search(masses)
        idx = np.minimum(idx, self.size - 1)
        prios = self._tree.tree[idx + self._tree.capacity]
        probs = prios / max(total, 1e-12)
        weights = (self.size * probs + 1e-12) ** -beta
        weights = (weights / weights.max()).astype(np.float32)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx],
                "weights": weights, "idx": idx,
                "discounts": self.discounts[idx]}

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray):
        priority = (np.abs(td_errors) + self.eps) ** self.alpha
        self._tree.set(np.asarray(idx), priority)
        self._max_priority = max(self._max_priority,
                                 float(np.abs(td_errors).max()) + self.eps)


def nstep_batch(batch: dict, n_step: int, gamma: float) -> dict:
    """Fold a TIME-ORDERED transition batch into n-step transitions:
    reward_t <- sum_{i<h} gamma^i r_{t+i}, next_obs_t <- obs after the
    horizon, done_t <- any done within it, and ``discounts_t`` <- the
    BOOTSTRAP factor gamma^h (0 when the horizon hit a terminal), so the
    TD target is simply ``reward + discounts * Q(next_obs)`` even where
    the horizon h was clipped short. Clipping happens at episode ends
    and at the fragment boundary (same as the reference applies at
    episode ends). Works for n_step=1 too (discounts = gamma*(1-done))."""
    t = len(batch["obs"])
    if n_step <= 1:
        out = dict(batch)
        out["discounts"] = (gamma * (1.0 - batch["dones"])
                            ).astype(np.float32)
        return out
    rewards = np.zeros(t, np.float32)
    next_obs = np.empty_like(batch["next_obs"])
    dones = np.zeros(t, np.float32)
    discounts = np.zeros(t, np.float32)
    for i in range(t):
        acc, discount = 0.0, 1.0
        j = i
        while True:
            acc += discount * batch["rewards"][j]
            last = j
            if batch["dones"][j] or j == t - 1 or j - i + 1 >= n_step:
                break
            discount *= gamma
            j += 1
        h = last - i + 1
        rewards[i] = acc
        next_obs[i] = batch["next_obs"][last]
        terminal = batch["dones"][i:last + 1].max()
        dones[i] = terminal
        discounts[i] = 0.0 if terminal else gamma ** h
    out = dict(batch)
    out["rewards"] = rewards
    out["next_obs"] = next_obs
    out["dones"] = dones
    out["discounts"] = discounts
    return out
