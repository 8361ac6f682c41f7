"""The port's on-policy RLlib (``ray_tpu_torch/rllib/``) against the JAX
package's (``ray_tpu/rllib/``) on the CPU.

Inputs come from numpy generators with fixed seeds; weights from JAX's
``init_module``, carried over by ``convert.policy_value_from_numpy`` or
through JAX's own save file. Each parity check has a control, a changed
setting that must miss the check's tolerance:

- the environments, 200 seeded actions each, bit for bit (control: another
  seed of the env and the actions);
- the module's forward within 1e-6 (control: the square 64x64 layer read
  transposed);
- the PPO, A2C/PG, IMPALA and APPO losses' stats and gradients within
  1e-5 (relative to each leaf's largest entry) of ``_ppo_grads``,
  ``_a2c_update`` and ``_impala_grads``, on batches whose ratios reach
  past the clips (controls: ``clip_eps``, ``vf_coeff``,
  ``entropy_coeff``, ``rho_clip``, ``clip_param``);
- ``vtrace`` at [T 16, B 4], rho above and below both clips, with dones
  (control: ``gamma``);
- one Adam step against ``_ppo_update`` with ``optax.adam`` (control:
  ``clip_eps``);
- whole ``PPO.train()`` and ``IMPALA.train()`` iterations from JAX's save
  file, against the JAX algorithms: the rollout workers' batches bit for
  bit, the stats and the updated parameters within 1e-5 (control: the
  port at another ``gamma``).

Then the learning checks of ``tests/test_rllib.py`` on the port, its
entry points' device rules and IMPALA's recurrent save files across the
packages. The JAX runtime (rollout actors) starts once,
for the module.
"""

import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import pg as jpg
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import pg as tpg
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib.learner_group import Learner, loss_grads
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5
LAYERS = ("torso1", "torso2", "pi", "vf")


@pytest.fixture(scope="module")
def rt():
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    yield
    ray_tpu.shutdown()


def jax_params(obs_dim, n_actions, seed=0, hidden=64):
    return jax.tree.map(np.asarray, jppo.init_module(
        jax.random.key(seed), obs_dim, n_actions, hidden))


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got: dict, want: dict) -> float:
    return max(rel_err(got[k][leaf], want[k][leaf])
               for k in LAYERS for leaf in ("w", "b"))


def stats_err(got: dict, want: dict) -> float:
    return max(rel_err(float(got[k]), float(want[k])) for k in want)


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------

ENVS = ["CartPole-v1", "Bandit-v0", "Pendulum-v1", "ContinuousBandit-v0",
        "PixelCartPole-v0", "MountainCar-v0"]


def roll(make, name, seed, steps=200):
    env = make(name, seed=seed)
    rng = np.random.default_rng(seed)
    out = [env.reset()]
    for _ in range(steps):
        if getattr(env, "continuous", False):
            a = rng.uniform(env.action_low, env.action_high,
                            size=env.action_dim)
        else:
            a = int(rng.integers(env.n_actions))
        obs, r, d, _ = env.step(a)
        out += [obs, np.float64(r), np.bool_(d)]
        if d:
            out.append(env.reset())
    return out


def same_roll(a, b) -> bool:
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ENVS)
def test_env_matches_jax_bit_for_bit(name):
    want = roll(jenv.make_env, name, seed=7)
    assert same_roll(roll(tenv.make_env, name, seed=7), want)
    # control: another seed (of the env and of the actions)
    assert not same_roll(roll(tenv.make_env, name, seed=8), want)


def test_unknown_env_raises():
    with pytest.raises(KeyError):
        tenv.make_env("NoSuchEnv-v9")


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def test_module_forward_matches_jax():
    params = jax_params(4, 2)
    obs = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    want_logits, want_values = jppo.forward_module(
        jax.tree.map(jnp.asarray, params), jnp.asarray(obs))
    module = convert.policy_value_from_numpy(params, device="cpu")
    logits, values = module(torch.from_numpy(obs))
    assert rel_err(logits.detach().numpy(), want_logits) < 1e-6
    assert rel_err(values.detach().numpy(), want_values) < 1e-6
    assert tree_err(module.numpy_tree(), params) == 0.0
    # control: the square 64x64 layer read transposed (nn.Linear's layout)
    bad = {**params, "torso2": {"w": params["torso2"]["w"].T.copy(),
                                "b": params["torso2"]["b"]}}
    logits, _ = convert.policy_value_from_numpy(bad, device="cpu")(
        torch.from_numpy(obs))
    assert rel_err(logits.detach().numpy(), want_logits) > 1e-6


def test_init_module_is_he_normal_from_a_cpu_generator():
    m = tppo.init_module(3, 4, 2, 64, device="cpu")
    again = tppo.init_module(3, 4, 2, 64, device="cpu")
    assert tree_err(m.numpy_tree(), again.numpy_tree()) == 0.0
    tree = m.numpy_tree()
    assert {k: tree[k]["w"].shape for k in LAYERS} == {
        "torso1": (4, 64), "torso2": (64, 64), "pi": (64, 2),
        "vf": (64, 1)}
    assert all(not tree[k]["b"].any() for k in LAYERS)
    # the scale (2/fan_in)**0.5 on the 64x64 layer: std 0.177
    assert abs(tree["torso2"]["w"].std() - (2 / 64) ** 0.5) < 0.01


def test_converter_refuses_a_malformed_tree():
    params = jax_params(4, 2)
    with pytest.raises(ValueError, match="shapes"):
        convert.policy_value_from_numpy(
            {**params, "vf": {"w": params["vf"]["w"][:, :0],
                              "b": params["vf"]["b"]}}, device="cpu")
    with pytest.raises(ValueError, match="not a policy/value tree"):
        convert.policy_value_from_numpy({"torso1": params["torso1"]},
                                        device="cpu")


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------

def capture():
    """An optax transformation whose state after an update is the
    gradients themselves (and whose updates are zero): the exact
    gradients out of ``_a2c_update``."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def port_grads(loss_fn, params, batch):
    module = convert.policy_value_from_numpy(params, device="cpu")
    grads, stats = loss_grads(loss_fn, module, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n.split(".") for n, _ in module.named_parameters()]
    tree = {k: {} for k in LAYERS}
    for (layer, leaf), g in zip(names, grads):
        tree[layer][leaf] = g.numpy()
    return tree, {k: float(v) for k, v in stats.items()}


def ppo_batch(params, n=96, seed=1):
    """Observations, actions and advantages from a generator, and old
    log-probabilities 0.4 nats from the policy's on average, so that the
    clip binds on some rows on either side."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, size=n).astype(np.int32)
    logits, _ = jppo._np_forward(params, obs)
    logp = np.log(jppo._softmax_rows(logits)[np.arange(n), actions])
    return {"obs": obs, "actions": actions,
            "logp": (logp + rng.normal(0, 0.4, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(2.0, 3.0, size=n).astype(np.float32)}


def assert_grads_match(got, want, control):
    (g, s), (wg, ws), (cg, cs) = got, want, control
    assert tree_err(g, wg) < TOL and stats_err(s, ws) < TOL
    assert max(tree_err(cg, wg), stats_err(cs, ws)) > TOL


def test_ppo_loss_matches_jax_grads():
    params = jax_params(4, 2)
    batch = ppo_batch(params)
    kw = dict(clip_eps=0.2, entropy_coeff=0.01, vf_coeff=0.5)
    jgrads, jstats = jppo._ppo_grads(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    want = (jax.tree.map(np.asarray, jgrads), jstats)
    assert_grads_match(
        port_grads(partial(tppo.ppo_loss, **kw), params, batch), want,
        port_grads(partial(tppo.ppo_loss, **{**kw, "clip_eps": 0.1}),
                   params, batch))


@pytest.mark.parametrize("use_critic", [True, False], ids=["a2c", "pg"])
def test_a2c_and_pg_loss_match_jax(use_critic):
    params = jax_params(4, 2)
    batch = {k: v for k, v in ppo_batch(params).items() if k != "logp"}
    kw = dict(entropy_coeff=0.01, vf_coeff=0.5, use_critic=use_critic)
    _, jgrads, jstats = jpg._a2c_update(
        jax.tree.map(jnp.asarray, params), capture().init(params),
        {k: jnp.asarray(v) for k, v in batch.items()}, tx=capture(), **kw)
    want = (jax.tree.map(np.asarray, jgrads), jstats)
    # control: the critic's weight (A2C), the entropy bonus's (PG, whose
    # total leaves the value loss out)
    bad = {"vf_coeff": 0.25} if use_critic else {"entropy_coeff": 0.05}
    assert_grads_match(
        port_grads(partial(tpg.a2c_loss, **kw), params, batch), want,
        port_grads(partial(tpg.a2c_loss, **{**kw, **bad}), params, batch))


def impala_batch(B=4, T=16, seed=2):
    """Trajectories whose behavior logits are drawn apart from the policy's,
    so that rho runs well above and below the clips."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(B, T, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, size=(B, T)).astype(np.int32),
            "behavior_logits": rng.normal(0, 1.5, size=(B, T, 2)).astype(
                np.float32),
            "rewards": rng.normal(1.0, 1.0, size=(B, T)).astype(np.float32),
            "dones": (rng.random((B, T)) < 0.1).astype(np.float32),
            "bootstrap_obs": rng.normal(size=(B, 4)).astype(np.float32)}


@pytest.mark.parametrize("clip_param,control", [
    (None, {"rho_clip": 0.5}), (0.3, {"clip_param": 0.1})],
    ids=["impala", "appo"])
def test_impala_and_appo_loss_match_jax(clip_param, control):
    params = jax_params(4, 2)
    batch = impala_batch()
    kw = dict(gamma=0.99, rho_clip=1.0, c_clip=1.0, entropy_coeff=0.01,
              vf_coeff=0.5, clip_param=clip_param)
    jgrads, jstats = jimpala._impala_grads(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    want = (jax.tree.map(np.asarray, jgrads), jstats)
    assert_grads_match(
        port_grads(partial(timpala.impala_loss, **kw), params, batch), want,
        port_grads(partial(timpala.impala_loss, **{**kw, **control}),
                   params, batch))


def test_vtrace_matches_jax():
    T, B = 16, 4
    rng = np.random.default_rng(3)
    behavior = rng.normal(-0.7, 0.3, size=(T, B)).astype(np.float32)
    target = (behavior + rng.normal(0, 0.8, size=(T, B))).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32)
    dones = (rng.random((T, B)) < 0.15).astype(np.float32)
    rho = np.exp(target - behavior)
    assert (rho > 1.5).any() and (rho < 0.8).any() and dones.any()
    args = (behavior, target, rewards, values, bootstrap, dones)
    kw = dict(gamma=0.95, rho_clip=1.5, c_clip=0.8)
    want = jimpala.vtrace(*map(jnp.asarray, args), **kw)

    def port(**over):
        return timpala.vtrace(*map(torch.from_numpy, args), **{**kw, **over})

    for got, w in zip(port(), want):
        assert rel_err(got.numpy(), w) < TOL
    # control: another discount
    assert rel_err(port(gamma=0.9)[0].numpy(), want[0]) > TOL


def test_one_adam_step_matches_ppo_update():
    params = jax_params(4, 2)
    batch = ppo_batch(params)
    kw = dict(clip_eps=0.2, entropy_coeff=0.01, vf_coeff=0.5)
    tx = optax.adam(3e-4)
    jp = jax.tree.map(jnp.asarray, params)
    new, _, jstats = jppo._ppo_update(
        jp, tx.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
        tx=tx, **kw)
    want = jax.tree.map(np.asarray, new)

    def step(**over):
        learner = Learner(
            init_fn=partial(tppo.init_module, obs_dim=4, n_actions=2),
            loss_fn=partial(tppo.ppo_loss, **{**kw, **over}),
            tx=tppo.adam(3e-4), seed=0, device="cpu")
        learner.set_params(params)
        stats = learner.update(batch)
        return learner.get_params(), stats

    got, stats = step()
    assert tree_err(got, want) < TOL and stats_err(stats, jstats) < TOL
    # control: another clip
    assert tree_err(step(clip_eps=0.05)[0], want) > TOL


# ---------------------------------------------------------------------------
# Whole iterations
# ---------------------------------------------------------------------------

def same_batch(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k] == b[k] if isinstance(a[k], list) else
        (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
        for k in a)


def test_rollout_workers_sample_jax_batches_bit_for_bit():
    params = jax_params(4, 2)
    jw, tw = jppo._RolloutWorker("CartPole-v1", 1000, 2), \
        tppo._RolloutWorker("CartPole-v1", 1000, 2)
    for _ in range(2):
        assert same_batch(tw.sample(params, 128, 0.99, 0.95),
                          jw.sample(params, 128, 0.99, 0.95))
    jt, tt = jimpala._TrajectoryWorker("CartPole-v1", 2000, 2), \
        timpala._TrajectoryWorker("CartPole-v1", 2000, 2)
    for _ in range(2):
        assert same_batch(tt.sample(params, 64), jt.sample(params, 64))
    # the parameters the port's learner hands its workers sample the same
    module = convert.policy_value_from_numpy(params, device="cpu")
    assert same_batch(
        tppo._RolloutWorker("CartPole-v1", 1000).sample(
            module.numpy_tree(), 64, 0.99, 0.95),
        jppo._RolloutWorker("CartPole-v1", 1000).sample(
            params, 64, 0.99, 0.95))
    # control: another seed
    assert not same_batch(
        tppo._RolloutWorker("CartPole-v1", 1001).sample(params, 64, 0.99,
                                                        0.95),
        jppo._RolloutWorker("CartPole-v1", 1000).sample(params, 64, 0.99,
                                                        0.95))


RESULT_KEYS = ("policy_loss", "vf_loss", "entropy")


def check_iteration(got: dict, want: dict, keys) -> float:
    for k in ("training_iteration", "num_episodes", "episode_return_mean"):
        assert got[k] == want[k], k
    return max(rel_err(got[k], want[k]) for k in keys)


def test_ppo_iteration_matches_jax(rt, tmp_path):
    path = str(tmp_path / "ppo.pkl")
    jalgo = jppo.PPOConfig().build()
    try:
        jalgo.save(path)
        want = jalgo.train()
        want_params = jalgo._params_np()
    finally:
        jalgo.stop()
    for gamma in (0.99, 0.9):
        algo = tppo.PPOConfig(device="cpu", gamma=gamma).build()
        algo.restore(path)
        got = algo.train()
        errs = (check_iteration(got, want, RESULT_KEYS),
                tree_err(algo.learner.get_params(), want_params))
        if gamma == 0.99:
            assert max(errs) < TOL, errs
            assert got["num_env_steps_sampled"] == 512
        else:   # control: another discount
            assert min(errs) > TOL, errs


def test_impala_two_iterations_match_jax(rt, tmp_path):
    path = str(tmp_path / "impala.pkl")
    jalgo = jimpala.IMPALAConfig().build()
    try:
        jalgo.save(path)
        want = [jalgo.train() for _ in range(2)]
        want_params = jalgo._params_np()
    finally:
        jalgo.stop()
    for gamma in (0.99, 0.9):
        algo = timpala.IMPALAConfig(device="cpu", gamma=gamma).build()
        algo.restore(path)
        got = [algo.train() for _ in range(2)]
        errs = [check_iteration(g, w, RESULT_KEYS + ("mean_rho",))
                for g, w in zip(got, want)]
        errs.append(tree_err(algo.learner.get_params(), want_params))
        if gamma == 0.99:
            assert max(errs) < TOL, errs
        else:   # control: another discount (vf_loss and the update move)
            assert min(errs) > TOL, errs


def test_port_checkpoint_restores_into_jax(rt, tmp_path):
    path = str(tmp_path / "ckpt.pkl")
    algo = tppo.PPOConfig(device="cpu").environment("Bandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=64).build()
    algo.train()
    algo.save(path)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert tree_err(saved, algo.learner.get_params()) == 0.0
    jalgo = jppo.PPOConfig().environment("Bandit-v0").rollouts(
        num_rollout_workers=1, rollout_fragment_length=64).build()
    try:
        jalgo.restore(path)
        for obs in ([1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]):
            assert jalgo.compute_action(np.array(obs)) == \
                algo.compute_action(np.array(obs))
    finally:
        jalgo.stop()


# ---------------------------------------------------------------------------
# Learning (tests/test_rllib.py's checks, on the port) and entry points
# ---------------------------------------------------------------------------

def test_ppo_learns_bandit():
    algo = (tppo.PPOConfig(device="cpu").environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=0.01, num_sgd_iter=4, minibatch_size=128,
                      entropy_coeff=0.0, gamma=0.0).build())
    first = algo.train()["episode_return_mean"]
    for _ in range(6):
        last = algo.train()["episode_return_mean"]
    assert last > 0.85, (first, last)


def test_impala_learns_bandit():
    algo = (timpala.IMPALAConfig(device="cpu").environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, unroll_length=64)
            .training(lr=0.02).build())
    for _ in range(15):
        result = algo.train()
    assert result["training_iteration"] == 15
    assert 0.3 < result["mean_rho"] < 3.0
    assert algo.compute_action([1.0, 1.0]) == 1
    assert algo.compute_action([-1.0, 1.0]) == 0


def test_appo_learns_bandit():
    from ray_tpu_torch.rllib import APPOConfig

    algo = (APPOConfig(device="cpu").environment("Bandit-v0")
            .rollouts(num_rollout_workers=2, unroll_length=64)
            .training(lr=5e-2, entropy_coeff=0.0).build())
    assert algo.config.clip_param == 0.3
    for _ in range(10):
        result = algo.train()
    assert result["episode_return_mean"] > 0.85, result


@pytest.mark.parametrize("name", ["A2CConfig", "PGConfig"])
def test_a2c_and_pg_train(name):
    algo = getattr(tpg, name)(device="cpu").rollouts(
        rollout_fragment_length=128).build()
    for i in range(2):
        result = algo.train()
    assert result["training_iteration"] == 2
    assert result["num_env_steps_sampled"] == 256
    assert all(np.isfinite(result[k]) for k in RESULT_KEYS)
    assert result["entropy"] > 0


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    """The algorithms default to device "cuda" and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, DreamerV3Config,
                                     IMPALAConfig, MultiAgentPPOConfig,
                                     PGConfig, PPOConfig, RecurrentPPOConfig)

    for cfg in (PPOConfig(), A2CConfig(), PGConfig(), IMPALAConfig(),
                APPOConfig(), IMPALAConfig(cell="gru"),
                APPOConfig(cell="lstm"), RecurrentPPOConfig(),
                MultiAgentPPOConfig(), DreamerV3Config()):
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cfg.build()


def test_impala_cell_save_files_read_by_both_packages(rt, tmp_path):
    """IMPALA with a recurrent core: the port's save file (the numpy tree
    with ``cell_type``) restored into JAX's IMPALA, and JAX's into the
    port's, the parameters bit for bit and the greedy actions and carried
    states equal over an episode's steps (control: the port's file read
    into an IMPALA of the other cell, which refuses it)."""
    from ray_tpu.rllib.recurrent import MemoryCueEnv as JaxCue
    from ray_tpu_torch.rllib.recurrent import MemoryCueEnv

    def same_params(a: dict, b: dict) -> bool:
        return set(a) == set(b) and a["cell_type"] == b["cell_type"] and all(
            np.array_equal(a[k][leaf], b[k][leaf]) for k in a
            if k != "cell_type" for leaf in ("w", "b"))

    algo = (timpala.IMPALAConfig(device="cpu").environment(MemoryCueEnv)
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4)
            .training(cell="gru", unroll_length=16, hidden=16).build())
    algo.train()
    path = str(tmp_path / "port.pkl")
    algo.save(path)
    jalgo = (jimpala.IMPALAConfig().environment(JaxCue)
             .rollouts(num_rollout_workers=1)
             .training(cell="gru", hidden=16).build())
    try:
        jalgo.restore(path)
        saved = jalgo._params_np()
        assert saved["cell_type"] == "gru"
        assert same_params(saved, algo._params_np())
        state_j = state_t = None
        for obs in ([1.0, 0.0], [0.0, 2 / 3], [0.0, 1 / 3], [-1.0, 0.0]):
            a_j, state_j = jalgo.compute_action(obs, state_j)
            a_t, state_t = algo.compute_action(obs, state_t)
            assert a_j == a_t and np.array_equal(state_j, state_t)
        jpath = str(tmp_path / "jax.pkl")
        jalgo.save(jpath)
    finally:
        jalgo.stop()
    fresh = timpala.IMPALAConfig(device="cpu").training(
        cell="gru", hidden=16).environment(MemoryCueEnv).build()
    fresh.restore(jpath)
    assert same_params(fresh._params_np(), algo._params_np())
    # control: a file of a gru core read into an lstm IMPALA
    with pytest.raises(ValueError, match="cell_type"):
        timpala.IMPALAConfig(device="cpu").training(
            cell="lstm", hidden=16).environment(MemoryCueEnv).build(
        ).restore(path)
