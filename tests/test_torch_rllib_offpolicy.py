"""The port's replay algorithms (``ray_tpu_torch/rllib/{dqn,replay,sac,
td3}.py``) against the JAX package's on the CPU.

Inputs come from numpy generators with fixed seeds; weights from JAX's
initialisers, carried over by ``convert.policy_value_from_numpy`` (DQN's
Q-net, also through JAX's save file) and ``convert.mlp_tree_from_numpy``
(SAC's and TD3's list-of-layers trees). Noise is an input of the port's
updates: the tests feed them JAX's draws, and replace ``SAC._noise`` and
``TD3._noise`` with JAX's key chain (``jax_noise``), so whole iterations
can be held against JAX. Each parity check has a control that must miss:

- ``ReplayBuffer``, ``SumTree``, ``PrioritizedReplayBuffer`` (through a
  wrap-around) and ``nstep_batch`` (n 1 and 3, with dones) bit for bit
  (controls: another generator, other priorities);
- the DQN loss, |TD| and one Adam step of ``_dqn_update`` with double Q on
  and off and with dueling, and ``_c51_update`` on batches with terminals
  and ``tz`` past both ends of the support, within 1e-5 of each leaf's
  largest entry (controls: ``double_q`` flipped; the ``lo == hi`` mass
  counted twice);
- ``_sac_update`` (control: the critics unstopped in the actor loss) and
  ``_td3_update`` from nonzero moments, off a policy step and on one
  (control: the actor's gradient zeroed in place of the gated update).
  SAC's squashing tanh replays JAX's values in the port (``ReplayTanh``),
  or takes XLA's tanh (``xla_tanh``) where JAX's are out of reach:
  float32 tanh differs in the last ulp between XLA and torch on most
  inputs, and SAC's correction ``log(1 - a**2 + 1e-6)`` turns one ulp
  near saturation into up to 0.4 nats of a row's log-prob
  (``test_sac_log_prob_differs_only_where_tanh_does``). SAC's second
  step, SAC's iterations and nothing else are held within
  ``floor_bound``: twice JAX's own difference between two compiles of
  the same update, where that passes 1e-5;
- the rollout workers' batches bit for bit;
- whole ``DQN.train()`` iterations restored from JAX's save file (the
  batches bit for bit; the stats and parameters within 1e-5), and
  ``SAC``, ``TD3`` and ``DDPG`` iterations, each started from JAX's
  state (parameters, targets and Adam moments through the converter):
  the batches bit for bit, the stats and parameters within 1e-5 (control:
  the port at another ``gamma``). Each continuous iteration starts from
  JAX's state because a Pendulum rollout amplifies a 1e-7 difference of
  the actor into 1e-5 of the states within 64 steps. Prioritized replay
  is held at the buffer, where both packages' buffers take the same |TD|
  arrays (JAX's): a float32 |TD| one ulp apart can move a stratified
  draw across a leaf of the sum tree.

Then the learning checks of ``tests/test_rllib.py`` and
``tests/test_replay.py`` on the port with ``device="cpu"``. The JAX
runtime (DQN's rollout actors) starts once, for the module.
"""

import functools
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import replay as jreplay
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib import td3 as jtd3
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import replay as treplay
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib import td3 as ttd3
from ray_tpu_torch.rllib.ppo import adam
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5


@pytest.fixture(scope="module")
def rt():
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    yield
    ray_tpu.shutdown()


class XlaTanh(torch.autograd.Function):
    """tanh with XLA's float32 values (JAX's gradient rule)."""

    @staticmethod
    def forward(ctx, x):
        a = torch.from_numpy(np.array(jax.jit(jnp.tanh)(x.detach().numpy())))
        ctx.save_for_backward(a)
        return a

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return g * (1 + a) * (1 - a)


@pytest.fixture
def xla_tanh(monkeypatch):
    monkeypatch.setattr(tsac, "_tanh", XlaTanh.apply)


# JAX's program compiled with LLVM's backend optimisations off (its float32
# arithmetic as written: no contraction into fused multiply-adds): how far
# that run lands from the default compile is JAX's own float32 noise
FLOOR_OPTIONS = {"xla_backend_optimization_level": 0}


def floor_bound(floor: float) -> float:
    """TOL, or twice JAX's own noise (``FLOOR_OPTIONS``) where that is
    larger: the Adam ratio of a gradient near its eps takes float32 noise
    past 1e-5 of a bias leaf's largest entry within a few steps (one
    sample of that noise, doubled for its spread)."""
    return max(TOL, 2 * floor)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got, want) -> float:
    """The worst leaf's ``rel_err`` over two numpy trees of one
    structure."""
    return max(jax.tree.leaves(jax.tree.map(rel_err, got, want)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def tensors(batch: dict) -> dict:
    return tdqn.to_device(batch, "cpu")


def qnet(obs_dim, n_actions, seed, num_atoms=1, hidden=64):
    return np_tree(jdqn.init_qnet(jax.random.key(seed), obs_dim, n_actions,
                                  hidden, num_atoms))


def same(a: dict, b: dict) -> bool:
    """Equal keys, and each column equal in dtype and bits (lists equal)."""
    return set(a) == set(b) and all(
        a[k] == b[k] if isinstance(a[k], list) else
        (np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
         and np.array_equal(a[k], b[k]))
        for k in a)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

def transitions(n, obs_dim=3, seed=0, continuous=False, dones=True):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": (rng.uniform(-1, 1, (n, 2)).astype(np.float32)
                    if continuous else
                    rng.integers(0, 2, size=n).astype(np.int32)),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": ((rng.random(n) < 0.2) if dones
                  else np.zeros(n, bool)).astype(np.float32),
    }


def buffers_state(buf) -> dict:
    return {k: getattr(buf, k) for k in ("obs", "next_obs", "actions",
                                         "rewards", "dones", "discounts")}


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_replay_buffer_matches_jax_bit_for_bit(continuous):
    kw = (dict(action_shape=(2,), action_dtype=np.float32) if continuous
          else {})
    jb = jdqn.ReplayBuffer(50, 3, gamma=0.9, **kw)
    tb = tdqn.ReplayBuffer(50, 3, gamma=0.9, **kw)
    for i, n in enumerate((20, 20, 20, 70)):   # wraps, then overfills
        batch = transitions(n, seed=i, continuous=continuous)
        if i == 1:   # a batch that carries its own discounts
            batch["discounts"] = np.full(n, 0.5, np.float32)
        jb.add_batch(batch)
        tb.add_batch(batch)
        assert (tb.pos, tb.size) == (jb.pos, jb.size)
        assert same(buffers_state(tb), buffers_state(jb))
    want = jb.sample(16, np.random.default_rng(3))
    assert same(tb.sample(16, np.random.default_rng(3)), want)
    # control: another generator
    assert not same(tb.sample(16, np.random.default_rng(4)), want)


def test_sumtree_matches_jax():
    jt, tt = jreplay.SumTree(6), treplay.SumTree(6)
    prios = np.array([1.0, 0.0, 2.0, 3.0, 0.0, 4.0])
    for t in (jt, tt):
        t.set(np.arange(6), prios)
        t.set(np.array([2, 3]), np.array([5.0, 0.5]))
    assert tt.total == jt.total and np.array_equal(tt.tree, jt.tree)
    masses = np.random.default_rng(0).uniform(0, jt.total, 64)
    assert np.array_equal(tt.prefix_search(masses), jt.prefix_search(masses))


def test_prioritized_buffer_through_a_wraparound_bit_for_bit():
    """Both buffers take the same |TD| arrays, so their draws are equal
    bit for bit through a wrap-around of the ring."""
    jb = jreplay.PrioritizedReplayBuffer(32, 3, alpha=0.6)
    tb = treplay.PrioritizedReplayBuffer(32, 3, alpha=0.6)
    rng = np.random.default_rng(7)
    for i in range(5):   # 5 x 12 rows: the ring wraps
        batch = transitions(12, seed=10 + i)
        jb.add_batch(batch)
        tb.add_batch(batch)
        for beta in (0.4, 1.0):
            want = jb.sample(8, np.random.default_rng(i), beta=beta)
            got = tb.sample(8, np.random.default_rng(i), beta=beta)
            assert same(got, want)
        td = rng.exponential(size=8).astype(np.float32)
        jb.update_priorities(want["idx"], td)
        tb.update_priorities(got["idx"], td)
        assert np.array_equal(tb._tree.tree, jb._tree.tree)
        assert tb._max_priority == jb._max_priority
    # control: other priorities move the draws
    tb.update_priorities(np.arange(8), np.full(8, 50.0, np.float32))
    assert not same(tb.sample(8, np.random.default_rng(9), beta=0.4),
                    jb.sample(8, np.random.default_rng(9), beta=0.4))


@pytest.mark.parametrize("n_step", [1, 3])
def test_nstep_batch_matches_jax(n_step):
    batch = transitions(40, seed=5)
    assert batch["dones"].sum() >= 4
    want = jreplay.nstep_batch(batch, n_step, 0.9)
    assert same(treplay.nstep_batch(batch, n_step, 0.9), want)
    # control: another discount
    assert not same(treplay.nstep_batch(batch, n_step, 0.8), want)


# ---------------------------------------------------------------------------
# DQN and C51 updates
# ---------------------------------------------------------------------------

def dqn_batch(n=48, obs_dim=4, n_actions=2, seed=1):
    """Uniform and weighted rows, terminals and n-step discounts."""
    rng = np.random.default_rng(seed)
    b = transitions(n, obs_dim, seed)
    b["actions"] = rng.integers(0, n_actions, n).astype(np.int32)
    b["discounts"] = np.where(b["dones"] > 0, 0.0, 0.99 ** rng.integers(
        1, 4, n)).astype(np.float32)
    b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def jitted(update, lr, **kw):
    """JAX's ``update`` under jit with ``optax.adam(lr)``, as its
    algorithm runs it (one compile a configuration)."""
    tx = optax.adam(lr)
    return tx, jax.jit(partial(update, tx=tx, **kw))


def jax_step(update, params, target, batch, lr=1e-3, steps=1, **kw):
    """``steps`` of JAX's update from fresh Adam: the parameters, the last
    loss and its per-sample priorities."""
    tx, step = jitted(update, lr, **kw)
    p = jnp_tree(params)
    opt = tx.init(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        p, opt, loss, td = step(p, opt, jnp_tree(target), jb)
    return np_tree(p), float(loss), np.asarray(td)


def port_step(update, params, target, batch, lr=1e-3, steps=1, **kw):
    module = convert.policy_value_from_numpy(params, device="cpu")
    target = tdqn.frozen_copy(convert.policy_value_from_numpy(
        target, device="cpu"))
    tx = adam(lr)
    opt = tx.init(dict(module.named_parameters()))
    tb = tensors(batch)
    for _ in range(steps):
        loss, td = update(module, opt, target, tb, tx=tx, **kw)
    return module.numpy_tree(), float(loss), td.numpy()


def step_err(got, want) -> float:
    return max(tree_err(got[0], want[0]), rel_err(got[1], want[1]),
               rel_err(got[2], want[2]))


@pytest.mark.parametrize("double_q,dueling", [
    (True, False), (False, False), (True, True)],
    ids=["double", "single", "dueling"])
def test_dqn_update_matches_jax(double_q, dueling):
    params, target = qnet(4, 2, 0), qnet(4, 2, 1)
    batch = dqn_batch()
    kw = dict(double_q=double_q, dueling=dueling)
    want = jax_step(jdqn._dqn_update, params, target, batch, steps=2, **kw)
    got = port_step(tdqn._dqn_update, params, target, batch, steps=2, **kw)
    assert step_err(got, want) < TOL
    # control: double Q flipped
    ctl = port_step(tdqn._dqn_update, params, target, batch, steps=2,
                    **{**kw, "double_q": not double_q})
    assert step_err(ctl, want) > TOL


C51 = dict(n_actions=3, num_atoms=11, v_min=-1.0, v_max=1.0)


def c51_batch(n=48, seed=2):
    """Rewards on and off the support's atoms, past both of its ends, and
    terminals, so that ``tz`` is clipped at either end and ``b`` is
    integral on some rows (a terminal at an atom: a point mass)."""
    rng = np.random.default_rng(seed)
    b = dqn_batch(n, 4, C51["n_actions"], seed)
    b["rewards"] = rng.choice(np.array([-3.0, -0.6, 0.0, 0.37, 0.4, 2.5],
                                       np.float32), n)
    b["discounts"][: n // 4] = 0.0
    return b


def test_c51_batch_reaches_past_both_ends_and_integral_atoms():
    b = c51_batch()
    support = np.linspace(-1.0, 1.0, 11, dtype=np.float32)
    tz = b["rewards"][:, None] + b["discounts"][:, None] * support
    assert (tz < -1.0).any() and (tz > 1.0).any()
    assert ((b["discounts"] == 0) & (b["rewards"] == 0.0)).any()


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "single"])
def test_c51_update_matches_jax(double_q, monkeypatch):
    params = qnet(4, 3, 0, num_atoms=11)
    target = qnet(4, 3, 1, num_atoms=11)
    batch = c51_batch()
    kw = dict(double_q=double_q, **C51)
    want = jax_step(jdqn._c51_update, params, target, batch, steps=2, **kw)
    got = port_step(tdqn._c51_update, params, target, batch, steps=2, **kw)
    assert step_err(got, want) < TOL
    ctl = port_step(tdqn._c51_update, params, target, batch, steps=2,
                    **{**kw, "double_q": not double_q})
    assert step_err(ctl, want) > TOL

    # control: the lo == hi mass counted twice (w_hi = 1 - (hi - b), the
    # textbook form, which equals b - lo unless b is integral)
    def twice(p_next, rewards, discounts, support, v_min, v_max, delta):
        tz = torch.clamp(rewards[:, None] + discounts[:, None] * support,
                         v_min, v_max)
        b = (tz - v_min) / delta
        lo, hi = torch.floor(b).long(), torch.ceil(b).long()
        atoms = torch.arange(len(support))
        return ((lo[:, :, None] == atoms) * (p_next * (1 - (b - lo)))
                [:, :, None]).sum(1) + ((hi[:, :, None] == atoms)
                                       * (p_next * (1 - (hi - b)))
                                       [:, :, None]).sum(1)

    monkeypatch.setattr(tdqn, "_c51_project", twice)
    ctl = port_step(tdqn._c51_update, params, target, batch, steps=2, **kw)
    assert step_err(ctl, want) > TOL


def test_c51_projection_point_mass():
    """tests/test_replay.py's check on the port: with discounts 0 the
    projected target is a point mass at the clipped reward, and 300 steps
    of cross entropy move the online expected value to it."""
    n_actions, atoms = 2, 11
    params = tdqn.init_qnet(0, 3, n_actions, 32, atoms, device="cpu")
    target = tdqn.frozen_copy(params)
    tx = adam(5e-3)
    opt = tx.init(dict(params.named_parameters()))
    batch = tensors({
        "obs": np.ones((16, 3), np.float32),
        "next_obs": np.ones((16, 3), np.float32),
        "actions": np.zeros((16,), np.int32),
        "rewards": np.full((16,), 0.5, np.float32),
        "dones": np.ones((16,), np.float32),
        "discounts": np.zeros((16,), np.float32),
        "weights": np.ones((16,), np.float32)})
    for _ in range(300):
        tdqn._c51_update(params, opt, target, batch, tx=tx, double_q=True,
                         n_actions=n_actions, num_atoms=atoms, v_min=-1.0,
                         v_max=1.0)
    with torch.no_grad():
        dist = tdqn.dist_forward(params, batch["obs"][:1], n_actions, atoms)
    ev = float((dist[0, 0] * torch.linspace(-1, 1, atoms)).sum())
    assert abs(ev - 0.5) < 0.1, ev


def test_prioritized_nstep_update_feeds_jax_priorities_back():
    """A PER draw of 3-step transitions, one update on each side from the
    same draw (|TD| within 1e-5), then JAX's |TD| fed back to both
    buffers: the next draws are equal bit for bit."""
    rollout = transitions(96, 4, seed=3)
    folded = jreplay.nstep_batch(rollout, 3, 0.99)
    jb = jreplay.PrioritizedReplayBuffer(64, 4)
    tb = treplay.PrioritizedReplayBuffer(64, 4)
    jb.add_batch(folded)
    tb.add_batch(treplay.nstep_batch(rollout, 3, 0.99))
    params, target = qnet(4, 2, 0), qnet(4, 2, 1)
    for it in range(3):
        mb = jb.sample(32, np.random.default_rng(it), beta=0.5)
        tmb = tb.sample(32, np.random.default_rng(it), beta=0.5)
        assert same(tmb, mb)
        idx = mb.pop("idx")
        tmb.pop("idx")
        want = jax_step(jdqn._dqn_update, params, target, mb, double_q=True)
        got = port_step(tdqn._dqn_update, params, target, tmb,
                        double_q=True)
        assert step_err(got, want) < TOL
        jb.update_priorities(idx, want[2])
        tb.update_priorities(idx, want[2])
        params = want[0]


# ---------------------------------------------------------------------------
# SAC and TD3 updates
# ---------------------------------------------------------------------------

OBS, ACT = 3, 2


def cont_batch(n=40, seed=4):
    b = transitions(n, OBS, seed, continuous=True)
    b["actions"] = np.random.default_rng(seed).uniform(
        -1, 1, (n, ACT)).astype(np.float32)
    return b


def jax_sac_noise(key, n):
    """The two draws JAX's ``_sac_update`` makes from ``key`` [2, n, A]."""
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (n, ACT)))
                     for k in (k1, k2)])


def jax_noise(seed: int, per_update):
    """A ``_noise`` method drawing JAX's key chain: ``key, sub =
    split(key)`` an update, then ``per_update(sub, n)``."""
    key = jax.random.key(seed + 1)

    def draw(n):
        nonlocal key
        key, sub = jax.random.split(key)
        return per_update(sub, n)

    return draw


SAC_KW = dict(gamma=0.99, tau=0.05, target_entropy=-float(ACT))


class ReplayTanh(torch.autograd.Function):
    """tanh whose values are given (``a``), with tanh's gradient at them."""

    @staticmethod
    def forward(ctx, x, a):
        ctx.save_for_backward(a)
        return a.clone()

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return g * (1 + a) * (1 - a), None


SAC_LR = 3e-3
SAC_TX = optax.adam(SAC_LR)
_sac_update_jit = jax.jit(partial(jsac._sac_update, tx=SAC_TX, **SAC_KW))
_sample_action_jit = jax.jit(jsac._sample_action)


def jax_sac(steps, update=_sac_update_jit):
    """``steps`` of JAX's SAC update (jitted, as ``SAC`` runs it) from one
    tree (log_alpha moved off 0 so alpha's gradient paths differ): the
    inputs, the result and the squashed actions of each step's two
    samples, from ``jsac._sample_action`` under jit on the same
    parameters and keys."""
    params = np_tree(jsac.init_sac(jax.random.key(0), OBS, ACT, 32))
    params["log_alpha"] = np.float32(-0.3)
    targets = {k: np_tree(jsac.init_sac(jax.random.key(1), OBS, ACT, 32)[k])
               for k in ("q1", "q2")}
    keys = jax.random.split(jax.random.key(5), steps)
    batches = [cont_batch(seed=10 + i) for i in range(steps)]
    jp, jt = jnp_tree(params), jnp_tree(targets)
    opt = SAC_TX.init(jp)
    jm, squashed = [], []
    for key, b in zip(keys, batches):
        for obs, k in zip((b["next_obs"], b["obs"]), jax.random.split(key)):
            squashed.append(torch.from_numpy(np.array(
                _sample_action_jit(jp["actor"], jnp.asarray(obs), k)[0])))
        jp, jt, opt, m = update(
            jp, jt, opt, {k: jnp.asarray(v) for k, v in b.items()}, key)
        jm.append({k: float(v) for k, v in m.items()})
    return ((params, targets, keys, batches), squashed,
            (np_tree(jp), np_tree(jt), jm))


def port_sac(inputs, squashed, monkeypatch, stop=True):
    """The port's SAC updates on JAX's inputs, its squashing tanh
    replaying JAX's values; ``stop=False`` is the control, the critics
    read unstopped in the actor loss."""
    params, targets, keys, batches = inputs
    monkeypatch.undo()
    replay = iter(squashed)
    monkeypatch.setattr(tsac, "_tanh",
                        lambda x: ReplayTanh.apply(x, next(replay)))
    if not stop:
        monkeypatch.setattr(tsac, "_stopped", lambda tree: tree)
    tx = adam(SAC_LR)
    tp = convert.mlp_tree_from_numpy(params, device="cpu")
    tt = tsac.frozen_tree(convert.mlp_tree_from_numpy(targets, device="cpu"))
    opt = tdqn.init_opt_state(tx, tsac.leaves(tp))
    tm = []
    for key, b in zip(keys, batches):
        m = tsac._sac_update(tp, tt, opt, tensors(b), torch.from_numpy(
            jax_sac_noise(key, len(b["obs"]))), tx=tx, **SAC_KW)
        tm.append({k: float(v) for k, v in m.items()})
    monkeypatch.undo()
    return tsac.numpy_tree(tp), tsac.numpy_tree(tt), tm


def run_err(got, want) -> float:
    return max(tree_err(got[0], want[0]), tree_err(got[1], want[1]),
               max(rel_err(g[k], w[k]) for g, w in zip(got[2], want[2])
                   for k in w))


def test_sac_log_prob_differs_only_where_tanh_does(monkeypatch):
    """Squashed samples of 4096 rows at log-std near its clip: with JAX's
    tanh values replayed the port's log-probs agree within 1e-5 on every
    row; with torch's own tanh, the rows that miss are rows whose tanh
    differs from XLA's."""
    actor = np_tree(jsac.init_sac(jax.random.key(0), OBS, ACT, 32)["actor"])
    actor[-1]["b"][ACT:] = 1.5   # log-std near its clip: many saturate
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(4096, OBS)).astype(np.float32)
    eps = rng.normal(size=(4096, ACT)).astype(np.float32)
    mu, log_std = jsac._actor_dist(jnp_tree(actor), obs)
    a = np.array(jnp.tanh(mu + jnp.exp(log_std) * eps))
    # JAX's _sample_action draws its own eps; this is its body on ours
    want = np.asarray(jnp.sum(
        -0.5 * (eps ** 2 + 2 * log_std + jnp.log(2 * jnp.pi))
        - jnp.log(1 - a ** 2 + 1e-6), axis=-1))
    tree = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for layer in actor]

    def port_logp(tanh):
        monkeypatch.setattr(tsac, "_tanh", tanh)
        a, logp = tsac._sample_action(tree, torch.from_numpy(obs),
                                      torch.from_numpy(eps))
        return a.numpy(), logp.numpy()

    scale = np.max(np.abs(want))
    _, replayed = port_logp(lambda x: ReplayTanh.apply(
        x, torch.from_numpy(a)))
    assert np.max(np.abs(replayed - want)) / scale < TOL
    own_a, own = port_logp(torch.tanh)
    off = np.abs(own - want) / scale > TOL
    assert off.any() and not (off & ~(own_a != a).any(-1)).any()


def test_sac_update_matches_jax(monkeypatch):
    """One step within TOL; a second, from nonzero moments, within
    ``floor_bound``: JAX's own two compiles differ by about 1e-4 of the
    actor's bias leaves after two steps."""
    inputs, squashed, want = jax_sac(2)
    inputs1, squashed1, want1 = jax_sac(1)
    assert run_err(port_sac(inputs1, squashed1, monkeypatch), want1) < TOL
    assert run_err(port_sac(inputs1, squashed1, monkeypatch, stop=False),
                   want1) > TOL
    floor = run_err(jax_sac(2, jax.jit(partial(
        jsac._sac_update, tx=SAC_TX, **SAC_KW),
        compiler_options=FLOOR_OPTIONS))[2], want)
    bound = floor_bound(floor)
    assert run_err(port_sac(inputs, squashed, monkeypatch), want) < bound
    assert run_err(port_sac(inputs, squashed, monkeypatch, stop=False),
                   want) > bound


TD3_KW = dict(gamma=0.99, tau=0.05, target_noise=0.2, noise_clip=0.1)


def td3_params(twin_q):
    params = np_tree(jtd3.init_td3(jax.random.key(0), OBS, ACT, 32, twin_q))
    targets = np_tree(jtd3.init_td3(jax.random.key(1), OBS, ACT, 32, twin_q))
    return params, targets


def zeroed_gradient_update(params, targets, opt_state, batch, noise,
                           do_policy, *, tx, gamma, tau, target_noise,
                           noise_clip, twin_q):
    """The control: off a policy step, the actor's gradient zeroed and
    the update applied (the targets still wait for a policy step)."""
    with torch.no_grad():
        na = ttd3._pi(targets["actor"], batch["next_obs"])
        na = torch.clamp(na + torch.clamp(target_noise * noise, -noise_clip,
                                          noise_clip), -1, 1)
        tq = ttd3._q(targets["q1"], batch["next_obs"], na)
        if twin_q:
            tq = torch.minimum(tq, ttd3._q(targets["q2"], batch["next_obs"],
                                           na))
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * tq
    c_loss = sum(torch.mean((ttd3._q(params[k], batch["obs"],
                                     batch["actions"]) - target) ** 2)
                 for k in (("q1", "q2") if twin_q else ("q1",)))
    a_loss = -torch.mean(ttd3._q(tsac._stopped(params["q1"]), batch["obs"],
                                 ttd3._pi(params["actor"], batch["obs"])))
    leaves = tsac.leaves(params)
    grads = list(torch.autograd.grad(c_loss + a_loss, leaves))
    if not do_policy:
        for i in range(len(tsac.leaves(params["actor"]))):
            grads[i] = torch.zeros_like(grads[i])
    tx.update(leaves, grads, opt_state)
    if do_policy:
        tsac.polyak(targets, params, tau)
    return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}


# a policy step, an off-policy step (from nonzero moments), a policy step
TD3_STEPS = [True, False, True]


def td3_inputs(twin_q):
    params, targets = td3_params(twin_q)
    keys = jax.random.split(jax.random.key(6), len(TD3_STEPS))
    batches = [cont_batch(seed=20 + i) for i in range(len(TD3_STEPS))]
    return params, targets, keys, batches


def jax_td3(twin_q, lr=3e-3) -> list:
    """JAX's TD3 updates over ``TD3_STEPS``: (params, targets, metrics)
    after each."""
    params, targets, keys, batches = td3_inputs(twin_q)
    tx, step = jitted(jtd3._td3_update, lr, twin_q=twin_q, **TD3_KW)
    jp, jt = jnp_tree(params), jnp_tree(targets)
    opt = tx.init(jp)
    out = []
    for key, b, pol in zip(keys, batches, TD3_STEPS):
        jp, jt, opt, m = step(
            jp, jt, opt, {k: jnp.asarray(v) for k, v in b.items()}, key,
            jnp.asarray(pol))
        out.append((np_tree(jp), np_tree(jt),
                    [{k: float(v) for k, v in m.items()}]))
    return out


def port_td3(twin_q, update=ttd3._td3_update, lr=3e-3) -> list:
    """The port's TD3 updates over ``TD3_STEPS`` on JAX's inputs and
    noise: (params, targets, metrics) after each."""
    params, targets, keys, batches = td3_inputs(twin_q)
    tx = adam(lr)
    tp = convert.mlp_tree_from_numpy(params, device="cpu")
    tt = tsac.frozen_tree(convert.mlp_tree_from_numpy(targets, device="cpu"))
    opt = tdqn.init_opt_state(tx, tsac.leaves(tp))
    out = []
    for key, b, pol in zip(keys, batches, TD3_STEPS):
        noise = torch.from_numpy(np.array(jax.random.normal(
            key, (len(b["obs"]), ACT))))
        m = update(tp, tt, opt, tensors(b), noise, pol, tx=tx,
                   twin_q=twin_q, **TD3_KW)
        out.append((tsac.numpy_tree(tp), tsac.numpy_tree(tt),
                    [{k: float(v) for k, v in m.items()}]))
    return out


@pytest.mark.parametrize("twin_q", [True, False], ids=["td3", "ddpg"])
def test_td3_update_matches_jax(twin_q):
    want, got = jax_td3(twin_q), port_td3(twin_q)
    assert max(run_err(g, w) for g, w in zip(got, want)) < TOL
    # off the policy step the actor and the targets stay put
    assert tree_err(got[1][0]["actor"], got[0][0]["actor"]) == 0.0
    assert tree_err(got[1][1], got[0][1]) == 0.0
    # control: the gradient zeroed in place of the gated update, which
    # bites from the nonzero moments of the first step
    ctl = port_td3(twin_q, update=zeroed_gradient_update)
    assert tree_err(ctl[1][0]["actor"], want[1][0]["actor"]) > TOL


# ---------------------------------------------------------------------------
# Rollout workers
# ---------------------------------------------------------------------------

def test_rollout_workers_sample_jax_batches_bit_for_bit():
    params = qnet(4, 2, 0)
    support = np.linspace(-10, 10, 51, dtype=np.float32)
    for atoms, p, sup in ((1, params, None),
                          (51, qnet(4, 2, 0, num_atoms=51), support)):
        jw = jdqn._DQNRolloutWorker("CartPole-v1", 1000, atoms, sup)
        tw = tdqn._DQNRolloutWorker("CartPole-v1", 1000, atoms, sup)
        for eps in (1.0, 0.3):
            assert same(tw.sample(p, 64, eps), jw.sample(p, 64, eps))
    assert not same(
        tdqn._DQNRolloutWorker("CartPole-v1", 1001).sample(params, 64, 0.3),
        jdqn._DQNRolloutWorker("CartPole-v1", 1000).sample(params, 64, 0.3))
    actor = np_tree(jsac.init_sac(jax.random.key(0), 3, 1)["actor"])
    td3_actor = np_tree(jtd3.init_td3(jax.random.key(0), 3, 1)["actor"])
    for jw, tw, a in (
            (jsac._SACRolloutWorker("Pendulum-v1", 1000),
             tsac._SACRolloutWorker("Pendulum-v1", 1000), actor),
            (jtd3._TD3RolloutWorker("Pendulum-v1", 1000, 0.1),
             ttd3._TD3RolloutWorker("Pendulum-v1", 1000, 0.1), td3_actor)):
        for warmup in (True, False):
            assert same(tw.sample(a, 64, warmup), jw.sample(a, 64, warmup))


# ---------------------------------------------------------------------------
# Whole iterations
# ---------------------------------------------------------------------------

def buffer_rows(buf) -> dict:
    return {k: v[:buf.size] for k, v in buffers_state(buf).items()}


def result_err(got: dict, want: dict, keys) -> float:
    return max([0.0] + [rel_err(got[k], want[k]) for k in keys
                        if want.get(k) is not None])


DQN_SMALL = dict(learning_starts=256, num_updates_per_iter=8,
                 target_update_freq=2, epsilon_decay_iters=3)


def test_dqn_iterations_match_jax(rt, tmp_path):
    path = str(tmp_path / "dqn.pkl")
    jalgo = jdqn.DQNConfig().training(**DQN_SMALL).build()
    try:
        jalgo.save(path)
        want = [jalgo.train() for _ in range(3)]
        want_params = np_tree(jalgo.params)
        want_target = np_tree(jalgo.target_params)
        want_buffer = buffer_rows(jalgo.buffer)
    finally:
        jalgo.stop()
    assert want[0]["td_loss"] is not None   # every iteration updates
    for gamma in (0.99, 0.9):
        algo = tdqn.DQNConfig(device="cpu", gamma=gamma).training(
            **DQN_SMALL).build()
        algo.restore(path)
        got = [algo.train() for _ in range(3)]
        counts = [[g[k] == w[k] for k in (
            "training_iteration", "num_episodes", "episode_return_mean",
            "epsilon", "buffer_size")] for g, w in zip(got, want)]
        errs = [result_err(g, w, ("td_loss",)) for g, w in zip(got, want)]
        errs += [tree_err(algo.params.numpy_tree(), want_params),
                 tree_err(algo.target_params.numpy_tree(), want_target)]
        if gamma == 0.99:
            assert all(map(all, counts)), counts
            assert same(buffer_rows(algo.buffer), want_buffer)
            assert max(errs) < TOL, errs
        else:   # control: another discount
            assert min(errs) > TOL, errs


def adam_moments(jalgo, device="cpu") -> tuple:
    """JAX's ``optax.adam`` moments of a SAC or TD3 tree, in the port's
    leaf order, and the step count."""
    state = jalgo.opt_state[0]
    return int(state.count), [
        [x.detach() for x in tsac.leaves(convert.mlp_tree_from_numpy(
            np_tree(m), device=device))] for m in (state.mu, state.nu)]


def sync_from_jax(algo, jalgo, targets: str) -> None:
    """The port's algorithm set to JAX's learner state: parameters,
    targets and Adam moments (the buffers, generators and workers already
    agree)."""
    algo.params = convert.mlp_tree_from_numpy(np_tree(jalgo.params),
                                              device="cpu")
    setattr(algo, targets, tsac.frozen_tree(convert.mlp_tree_from_numpy(
        np_tree(getattr(jalgo, targets)), device="cpu")))
    count, (mu, nu) = adam_moments(jalgo)
    algo.opt_state = {"count": count,
                      "mu": {str(i): m for i, m in enumerate(mu)},
                      "nu": {str(i): v for i, v in enumerate(nu)}}


def continuous_iterations(build_jax, make, targets: str, keys, noise,
                          floor=False):
    """Two ``train()`` calls of JAX's algorithm (``build_jax()``) and,
    from JAX's state before each, the port's built by ``make(gamma)`` at
    gamma 0.99 and at 0.9 (the control; ``noise()`` gives each its key
    chain). Returns each gamma's errors (the batch of each iteration bit
    for bit at 0.99) and, with ``floor``, JAX's own: a second JAX
    algorithm, its update compiled with ``FLOOR_OPTIONS``, run from the
    same states."""
    jalgo = build_jax()
    jfloor = build_jax() if floor else None
    if jfloor is not None:
        jfloor._update = jax.jit(jfloor._update.__wrapped__,
                                 compiler_options=FLOOR_OPTIONS)
    want, states, floor_errs = [], [], [0.0]
    try:
        for _ in range(2):
            state = np_tree({"params": jalgo.params,
                             "targets": getattr(jalgo, targets),
                             "opt": jalgo.opt_state})
            states.append(state)
            before = jalgo.buffer.size
            w = jalgo.train()
            want.append((w, np_tree(jalgo.params),
                         np_tree(getattr(jalgo, targets)),
                         {k: v[before:jalgo.buffer.size] for k, v in
                          buffers_state(jalgo.buffer).items()}))
            if jfloor is not None:
                jfloor.params = jnp_tree(state["params"])
                setattr(jfloor, targets, jnp_tree(state["targets"]))
                jfloor.opt_state = jnp_tree(state["opt"])
                f = jfloor.train()
                floor_errs += [
                    result_err(f, w, keys),
                    tree_err(np_tree(jfloor.params), want[-1][1]),
                    tree_err(np_tree(getattr(jfloor, targets)),
                             want[-1][2])]
    finally:
        jalgo.stop()
        if jfloor is not None:
            jfloor.stop()
    worst = {"floor": max(floor_errs)}
    for gamma in (0.99, 0.9):
        algo = make(gamma)
        algo._noise = noise()
        errs = []
        for state, (w, w_params, w_targets, w_rows) in zip(states, want):
            shadow = type("State", (), {
                "params": state["params"], targets: state["targets"],
                "opt_state": state["opt"]})
            sync_from_jax(algo, shadow, targets)
            before = algo.buffer.size
            g = algo.train()
            rows = {k: v[before:algo.buffer.size]
                    for k, v in buffers_state(algo.buffer).items()}
            if gamma == 0.99:
                assert same(rows, w_rows)
                for k in ("training_iteration", "episodes_this_iter",
                          "buffer_size"):
                    assert g[k] == w[k], k
            errs += [result_err(g, w, keys + ("episode_reward_mean",)),
                     tree_err(tsac.numpy_tree(algo.params), w_params),
                     tree_err(tsac.numpy_tree(getattr(algo, targets)),
                              w_targets)]
        worst[gamma] = max(errs)
    return worst


SMALL = dict(rollout_fragment_length=64, learning_starts=128,
             train_batch_size=32, num_updates_per_iter=4)


def test_sac_iterations_match_jax(rt, xla_tanh):
    """Held within ``floor_bound`` of JAX's own difference over the same
    iterations from the same states."""
    errs = continuous_iterations(
        lambda: jsac.SACConfig().training(**SMALL).build(),
        lambda gamma: tsac.SACConfig(
            device="cpu", gamma=gamma).training(**SMALL).build(),
        "target_q", ("critic_loss", "actor_loss", "alpha", "entropy"),
        lambda: jax_noise(0, lambda key, n: np.stack(
            [np.asarray(jax.random.normal(k, (n, 1)))
             for k in jax.random.split(key)])), floor=True)
    bound = floor_bound(errs["floor"])
    assert errs[0.99] < bound, errs
    assert errs[0.9] > bound, errs   # control: another discount


@pytest.mark.parametrize("name", ["TD3Config", "DDPGConfig"])
def test_td3_and_ddpg_iterations_match_jax(rt, name):
    def make(gamma):
        algo = getattr(ttd3, name)(device="cpu", gamma=gamma).training(
            **SMALL).build()
        assert type(algo).__name__ == name[:-len("Config")]
        return algo

    errs = continuous_iterations(
        lambda: getattr(jtd3, name)().training(**SMALL).build(), make,
        "targets", ("critic_loss", "actor_loss"),
        lambda: jax_noise(0, lambda key, n: np.asarray(
            jax.random.normal(key, (n, 1)))))
    assert errs[0.99] < TOL, errs
    assert errs[0.9] > TOL, errs   # control: another discount


def test_port_dqn_checkpoint_restores_into_jax(rt, tmp_path):
    path = str(tmp_path / "dqn.pkl")
    algo = tdqn.DQNConfig(device="cpu").environment("Bandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=64).training(
        learning_starts=64, num_updates_per_iter=8).build()
    algo.train()
    algo.save(path)
    with open(path, "rb") as f:
        assert tree_err(pickle.load(f), algo.params.numpy_tree()) == 0.0
    jalgo = jdqn.DQNConfig().environment("Bandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=16).build()
    try:
        jalgo.restore(path)
        for obs in ([1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]):
            assert jalgo.compute_action(np.array(obs)) == \
                algo.compute_action(np.array(obs))
    finally:
        jalgo.stop()


# ---------------------------------------------------------------------------
# Learning (tests/test_rllib.py's and tests/test_replay.py's checks, on
# the port), refusals and entry points
# ---------------------------------------------------------------------------

def test_dqn_learns_bandit():
    algo = (tdqn.DQNConfig(device="cpu").environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
            .training(learning_starts=64, num_updates_per_iter=16,
                      epsilon_decay_iters=5, target_update_freq=2).build())
    for _ in range(12):
        result = algo.train()
    assert result["training_iteration"] == 12
    assert result["buffer_size"] > 0 and result["td_loss"] is not None
    assert algo.compute_action([1.0, 1.0]) == 1
    assert algo.compute_action([-1.0, 1.0]) == 0


def test_dqn_save_restore(tmp_path):
    cfg = tdqn.DQNConfig(device="cpu").environment("Bandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=16)
    algo = cfg.build()
    algo.train()
    path = str(tmp_path / "dqn.ckpt")
    algo.save(path)
    obs = np.ones(algo.obs_dim, np.float32)
    algo2 = cfg.build()
    algo2.restore(path)
    assert algo2.compute_action(obs) == algo.compute_action(obs)


@pytest.mark.parametrize("kw", [
    dict(n_step=2, prioritized_replay=True), dict(dueling=True),
    dict(num_atoms=21, v_min=-1.0, v_max=2.0)],
    ids=["per_nstep", "dueling", "c51"])
def test_dqn_variants_learn_bandit(kw):
    algo = (tdqn.DQNConfig(device="cpu").environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=128)
            .training(lr=5e-3, learning_starts=128, epsilon_decay_iters=10,
                      **kw).build())
    last = 0.0
    for _ in range(30):
        last = algo.train()["episode_return_mean"]
        if last >= 0.9:
            break
    assert last >= 0.9


def test_dqn_refusals():
    with pytest.raises(ValueError, match="dueling"):
        tdqn.DQNConfig(device="cpu").training(dueling=True,
                                              num_atoms=51).build()
    with pytest.raises(ValueError, match="v_max > v_min"):
        tdqn.DQNConfig(device="cpu").training(num_atoms=21, v_min=1.0,
                                              v_max=1.0).build()


def test_sac_learns_continuous_bandit():
    algo = (tsac.SACConfig(device="cpu").environment("ContinuousBandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
            .training(learning_starts=128, train_batch_size=64,
                      num_updates_per_iter=64, lr=3e-3, gamma=0.0).build())
    for _ in range(12):
        result = algo.train()
    assert np.isfinite(result["critic_loss"]) and result["alpha"] > 0
    a = float(algo.compute_single_action(np.zeros(1, np.float32))[0])
    assert abs(a - 0.5) < 0.25, f"policy mean {a} far from optimum 0.5"


def test_td3_learns_continuous_bandit():
    algo = (ttd3.TD3Config(device="cpu").environment("ContinuousBandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=64)
            .training(learning_starts=128, train_batch_size=64,
                      num_updates_per_iter=64, lr=3e-3, gamma=0.0,
                      expl_noise=0.3).build())
    for _ in range(12):
        result = algo.train()
    assert np.isfinite(result["critic_loss"])
    a = float(algo.compute_single_action(np.zeros(1, np.float32))[0])
    assert abs(a - 0.5) < 0.25, f"policy {a} far from optimum 0.5"


def test_ddpg_is_td3_degenerate_config():
    cfg = ttd3.DDPGConfig(device="cpu").environment(
        "ContinuousBandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=32).training(
        learning_starts=32, num_updates_per_iter=8)
    assert cfg.twin_q is False and cfg.policy_delay == 1
    assert cfg.target_noise == 0.0
    algo = cfg.build()
    assert isinstance(algo, ttd3.DDPG)
    assert "q2" not in algo.params
    assert algo.train()["training_iteration"] == 1


def test_continuous_algorithms_refuse_a_discrete_env():
    for cfg in (tsac.SACConfig(device="cpu"), ttd3.TD3Config(device="cpu")):
        with pytest.raises(ValueError, match="continuous-action"):
            cfg.environment("CartPole-v1").build()


def test_mlp_tree_converter_refuses_a_malformed_tree():
    sac = np_tree(jsac.init_sac(jax.random.key(0), 3, 1))
    td3 = np_tree(jtd3.init_td3(jax.random.key(0), 3, 1, twin_q=False))
    got = convert.mlp_tree_from_numpy(sac, device="cpu")
    assert tree_err(tsac.numpy_tree(got), sac) == 0.0
    assert all(x.requires_grad for x in tsac.leaves(got))
    assert tree_err(tsac.numpy_tree(convert.mlp_tree_from_numpy(
        td3, device="cpu")), td3) == 0.0
    with pytest.raises(ValueError, match="not a SAC or TD3 tree"):
        convert.mlp_tree_from_numpy({"actor": sac["actor"]}, device="cpu")
    bad = [dict(layer) for layer in td3["actor"]]
    bad[1]["w"] = bad[1]["w"][:, :32]
    with pytest.raises(ValueError, match="do not chain"):
        convert.mlp_tree_from_numpy({**td3, "actor": bad}, device="cpu")
    with pytest.raises(ValueError, match="q1 maps"):
        convert.mlp_tree_from_numpy({**td3, "q1": sac["actor"]},
                                    device="cpu")


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    """The algorithms default to device "cuda" and raise without a card,
    before any worker."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cfg in (tdqn.DQNConfig(), tsac.SACConfig(), ttd3.TD3Config(),
                ttd3.DDPGConfig()):
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cfg.build()
