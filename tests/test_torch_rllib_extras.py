"""The port's numpy-only RLlib modules (``ray_tpu_torch/rllib/{bandit,es,
connectors}.py``) against the JAX package's on the CPU, bit for bit.

These modules are numpy in the JAX package and stay numpy in the port (a
copy with the port's ``make_env``, ES's fitness workers in this process).
Each check has a control that must miss:

- LinUCB's and LinTS's actions, rewards and arm statistics over 300
  steps, and their save files read by the other package (control:
  another seed);
- ES's noise table, ``_centered_ranks`` and the fitness workers' rollouts
  (control: another worker seed);
- one ES and one ARS iteration's ``theta``: the port's ``train()``
  against JAX's update run on JAX's workers' rollouts (a JAX algorithm
  shell with the port's state: JAX's ``train`` needs its runtime, which
  ``test_torch_rllib_more_runs.py`` starts for whole iterations);
  control: another ``lr``;
- every connector, the pipelines and ``ConnectorEnv`` over 200 steps,
  their outputs and ``state_dict``s, each state loaded into the other
  package's (control: another seed).
"""

import copy

import numpy as np
import pytest

from ray_tpu.rllib import bandit as jband
from ray_tpu.rllib import connectors as jcon
from ray_tpu.rllib import es as jes
from ray_tpu_torch.rllib import bandit as tband
from ray_tpu_torch.rllib import connectors as tcon
from ray_tpu_torch.rllib import es as tes
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)


def same(a, b) -> bool:
    """Equal structure, and each array equal in dtype and bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(a, b)
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# Bandits
# ---------------------------------------------------------------------------

def bandit_run(mod, name, seed):
    algo = getattr(mod, name)().training(steps_per_iteration=100,
                                         seed=seed, alpha=0.5).build()
    results = [algo.train() for _ in range(3)]
    arms = [(a.a_inv, a.b, a.theta, a.pulls) for a in algo.arms]
    actions = [algo.compute_action(np.asarray(x)) for x in
               ([1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [-1.0, -1.0])]
    return algo, (results, arms, actions)


@pytest.mark.parametrize("name", ["BanditLinUCBConfig", "BanditLinTSConfig"])
def test_linear_bandits_match_jax(name, tmp_path):
    jalgo, want = bandit_run(jband, name, 0)
    talgo, got = bandit_run(tband, name, 0)
    assert same(got, want)
    assert want[0][-1]["episode_return_mean"] > 0.8
    # save files read by the other package
    for src, dst_mod, tag in ((talgo, jband, "port"), (jalgo, tband, "jax")):
        path = str(tmp_path / tag)
        src.save(path)
        fresh = getattr(dst_mod, name)().build()
        fresh.restore(path)
        assert same([(a.a_inv, a.b, a.theta) for a in fresh.arms],
                    [(a.a_inv, a.b, a.theta) for a in src.arms])
    # control: another seed
    assert not same(bandit_run(tband, name, 1)[1], want)


# ---------------------------------------------------------------------------
# ES and ARS
# ---------------------------------------------------------------------------

def test_noise_table_and_centered_ranks_match_jax():
    table = tes.make_noise_table(seed=99, size=100_000)
    assert same(table, jes.make_noise_table(seed=99, size=100_000))
    assert not same(tes.make_noise_table(seed=98, size=100_000), table)
    assert tes.NOISE_TABLE_SIZE == jes.NOISE_TABLE_SIZE
    x = np.random.default_rng(0).standard_normal((16, 2))
    assert same(tes._centered_ranks(x), jes._centered_ranks(x))
    assert same(tes._centered_ranks(np.array([3.0])),
                jes._centered_ranks(np.array([3.0])))
    for args in ((4, 2, 32), (3, 1, 0)):
        assert tes._policy_shapes(*args) == jes._policy_shapes(*args)


@pytest.mark.parametrize("env", ["Bandit-v0", "Pendulum-v1"])
def test_fitness_workers_match_jax(env):
    discrete = env == "Bandit-v0"
    obs_dim, n_out = (2, 2) if discrete else (3, 1)
    shapes = tes._policy_shapes(obs_dim, n_out, 8)
    noise = tes.make_noise_table(seed=5, size=50_000)
    theta = np.random.default_rng(1).standard_normal(
        tes._flat_size(shapes)).astype(np.float32) * 0.1
    bounds = (None, None) if discrete else (-2.0, 2.0)
    stats = (np.zeros(obs_dim), np.ones(obs_dim))

    def run(mod, seed):
        w = mod._FitnessWorker(env, seed, noise, shapes, discrete, *bounds)
        return (w.do_rollouts(theta, 3, 0.1, 20, stats, 2),
                w.do_rollouts(theta, 2, 0.1, 20),
                w.eval_policy(theta, 2, 20, stats))

    want = run(jes, 7)
    assert same(run(tes, 7), want)
    assert not same(run(tes, 8), want)


def run_jax_iteration(shell, workers, per, sigma, steps, dirs):
    """The body of JAX's ``ES.train()`` with its workers called in this
    process, then JAX's own ``_update``."""
    outs = [w.do_rollouts(shell.theta, per, sigma, steps,
                          shell._obs_stats if shell._normalize_obs else None,
                          dirs) for w in workers]
    idxs = np.concatenate([o[0] for o in outs])
    pos = np.concatenate([o[1] for o in outs])
    neg = np.concatenate([o[2] for o in outs])
    if shell._normalize_obs:
        count = sum(o[4][0] for o in outs)
        if count > 1:
            total = np.sum([o[4][1] for o in outs], axis=0)
            sumsq = np.sum([o[4][2] for o in outs], axis=0)
            mean = total / count
            var = np.maximum(sumsq / count - mean * mean, 1e-8)
            shell._obs_stats = (mean, np.sqrt(var))
    shell._update(idxs, pos, neg)
    shell.iteration += 1


@pytest.mark.parametrize("name", ["ES", "ARS"])
def test_es_and_ars_iterations_match_jax(name):
    """Two iterations: the port's ``train()``; JAX's the body of its
    ``train()`` on JAX's fitness workers (same seeds, same table) and
    JAX's own ``_update``."""
    def port(lr):
        algo = getattr(tes, f"{name}Config")().environment(
            "Bandit-v0").training(**kw(lr)).build()
        thetas = []
        for _ in range(2):
            algo.train()
            thetas.append(algo.theta.copy())
        return algo, thetas

    def kw(lr):
        return dict(episodes_per_batch=8, sigma=0.3, max_episode_steps=20,
                    hidden=4 if name == "ES" else 0,
                    episodes_per_direction=2, lr=lr)

    lr = getattr(tes, f"{name}Config")().lr
    algo, got = port(lr)
    # JAX's shell starts from the port's state before its first iteration
    fresh = getattr(tes, f"{name}Config")().environment(
        "Bandit-v0").training(**kw(lr)).build()
    shell = object.__new__(getattr(jes, name))
    shell.__dict__.update({k: copy.deepcopy(v) for k, v in
                           fresh.__dict__.items() if k != "workers"})
    shell.config = getattr(jes, f"{name}Config")().environment(
        "Bandit-v0").training(**kw(lr))
    workers = [jes._FitnessWorker("Bandit-v0", 7 * (i + 1), shell.noise,
                                  shell.shapes, True)
               for i in range(shell.config.num_rollout_workers)]
    want = []
    for _ in range(2):
        run_jax_iteration(shell, workers, 4, 0.3, 20, 2)
        want.append(shell.theta.copy())
    assert same(got, want)
    assert not np.array_equal(got[0], got[1])
    if name == "ARS":
        assert algo._obs_stats is not None and same(algo._obs_stats,
                                                    shell._obs_stats)
    # control: another learning rate
    assert not same(port(2 * lr)[1], want)


def test_es_save_and_restore_across_packages(tmp_path):
    algo = tes.ESConfig().environment("Bandit-v0").training(
        hidden=0, episodes_per_batch=4, max_episode_steps=10).build()
    algo.train()
    path = str(tmp_path / "es")
    algo.save(path)
    shell = object.__new__(jes.ES)
    shell.restore(path)
    assert same(shell.theta, algo.theta)
    back = tes.ESConfig().environment("Bandit-v0").training(hidden=0).build()
    back.restore(path)
    assert same(back.theta, algo.theta)
    assert back.compute_action([1.0, 1.0]) == algo.compute_action([1.0, 1.0])


# ---------------------------------------------------------------------------
# Connectors
# ---------------------------------------------------------------------------

def obs_pipeline(mod):
    return [mod.FlattenObs(), mod.NormalizeObs(clip=3.0), mod.FrameStack(3)]


def connector_run(mod, seed, steps=200):
    rng = np.random.default_rng(seed)
    env = mod.ConnectorEnv("Pendulum-v1", seed=seed,
                           obs_connectors=obs_pipeline(mod),
                           action_connectors=[mod.UnsquashActions(-2.0, 2.0),
                                              mod.ClipActions(-1.5, 1.5)])
    out = [env.reset()]
    for _ in range(steps):
        obs, r, d, _ = env.step(rng.uniform(-1.5, 1.5, size=1))
        out += [obs, np.float64(r), np.bool_(d)]
        if d:
            out.append(env.reset())
    out.append(env.state_dict())
    out.append(env.obs_dim)     # reached through the wrapper
    return env, out


def test_connectors_match_jax_bit_for_bit():
    jenv, want = connector_run(jcon, 3)
    tenv, got = connector_run(tcon, 3)
    assert same(got, want)
    # each package's state loads into the other's and normalizes alike
    probe = np.array([0.3, -0.2, 1.1], np.float32)
    for src, dst_mod in ((tenv, jcon), (jenv, tcon)):
        dst = dst_mod.ConnectorPipeline(obs_pipeline(dst_mod))
        dst.load_state(src.state_dict()["obs"])
        dst.connectors[1].frozen = True
        src.obs_pipeline.connectors[1].frozen = True
        src.obs_pipeline.reset()
        dst.reset()
        assert same(dst(probe), src.obs_pipeline(probe))
        assert same(dst.state_dict(), src.state_dict()["obs"])
    # the single stages
    for stage in ("ClipActions", "UnsquashActions"):
        a = np.linspace(-3, 3, 13)
        assert same(getattr(tcon, stage)(-1.0, 2.0)(a),
                    getattr(jcon, stage)(-1.0, 2.0)(a))
    base = tcon.Connector()
    assert base.state_dict() == {} and base.reset() is None
    with pytest.raises(NotImplementedError):
        base(1.0)
    # control: another seed
    assert not same(connector_run(tcon, 4)[1], want)


# ---------------------------------------------------------------------------
# Learning (tests/test_rllib_extras.py's checks, on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("ES", dict(lr=0.1, hidden=0)), ("ARS", dict(lr=0.2, top_k=8))])
def test_es_and_ars_learn_bandit(name, kw):
    algo = (getattr(tes, f"{name}Config")().environment("Bandit-v0")
            .rollouts(num_rollout_workers=2)
            .training(episodes_per_batch=32, sigma=0.3,
                      episodes_per_direction=10, **kw).build())
    last = -np.inf
    for _ in range(30):
        last = algo.train()["episode_return_mean"]
        if last >= 0.8:
            break
    assert last >= 0.8
    if name == "ES":
        # deterministic eval should match or beat perturbed returns
        assert algo.evaluate(8)["episode_return_mean"] >= 0.8


def test_rllib_quickstart_runs_on_the_cpu():
    """``examples/rllib_quickstart.py`` (JAX's quickstart without its
    runtime): 10 PPO iterations on CartPole-v1, the stats finite and the
    return up from the first iteration."""
    from ray_tpu_torch.examples import rllib_quickstart

    results = rllib_quickstart.main(device="cpu")
    assert [r["training_iteration"] for r in results] == list(range(1, 11))
    assert all(np.isfinite(r[k]) for r in results
               for k in ("policy_loss", "vf_loss", "entropy"))
    assert results[-1]["episode_return_mean"] > \
        results[0]["episode_return_mean"]
