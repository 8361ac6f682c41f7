"""The port's offline RL (``ray_tpu_torch/rllib/{offline,estimators,
marwil}.py``) against the JAX package's on the CPU.

Each parity check has a control that must miss:

- a dataset written by each package and read by the other: the shards'
  arrays and ``meta.json`` bit for bit, and the minibatches of one
  generator equal (control: another generator);
- the BC, CQL and MARWIL updates against JAX's (BC's and CQL's jitted
  closures of their algorithms, ``_marwil_update``), the losses and one
  Adam step within 1e-5 of each leaf's largest entry (controls: the
  logged actions flipped, ``cql_alpha``, ``beta``), MARWIL on a batch
  whose weights reach their clip at 20;
- whole ``train()`` epochs of BC and CQL from JAX's parameters (CQL's
  target synced every 8 minibatches, counted across epochs) and MARWIL
  iterations from JAX's save file (control: another ``lr``,
  ``target_update_every``, ``adv_norm_decay``);
- ``ImportanceSampling`` and ``WeightedImportanceSampling`` on the same
  episodes and log-prob functions, equal (control: another ``gamma``).

Then the learning checks of ``tests/test_rllib_offline.py`` and
``tests/test_rllib_extras.py`` on the port with ``device="cpu"``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import estimators as jest
from ray_tpu.rllib import marwil as jmarwil
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import estimators as test_
from ray_tpu_torch.rllib import marwil as tmarwil
from ray_tpu_torch.rllib import offline as toff
from ray_tpu_torch.rllib.dqn import frozen_copy, to_device
from ray_tpu_torch.rllib.ppo import adam
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5


def floor_bound(floor: float) -> float:
    """TOL, or twice JAX's own noise where that is larger (its update run
    op by op against under jit): the Adam ratio of a gradient near its
    eps takes float32 noise past 1e-5 of a bias leaf's largest entry
    within a few steps (one sample of that noise, doubled for its
    spread)."""
    return max(TOL, 2 * floor)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got, want) -> float:
    return max(jax.tree.leaves(jax.tree.map(rel_err, got, want)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def module(tree):
    return convert.policy_value_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """A CartPole dataset written by each package (random behaviour, two
    shards), and the Bandit datasets of the learning checks."""
    root = tmp_path_factory.mktemp("offline")
    out = {}
    for name, pkg in (("jax", joff), ("port", toff)):
        path = str(root / f"cartpole_{name}")
        writer = pkg.DatasetWriter(path, shard_size=1500)
        out[name] = pkg.collect_dataset("CartPole-v1", str(root / name),
                                        num_steps=2000, seed=0)
        # the same rows through a writer that cuts them into two shards
        ds = pkg.OfflineDataset(out[name])
        writer.write(ds.data)
        writer.close()
        out[f"{name}_sharded"] = path
    return out


# ---------------------------------------------------------------------------
# Dataset IO
# ---------------------------------------------------------------------------

def shards(path) -> dict:
    files = sorted(f for f in os.listdir(path) if f.endswith(".npz"))
    out = {}
    for f in files:
        with np.load(os.path.join(path, f)) as z:
            out[f] = {k: z[k] for k in z.files}
    return out


def same_arrays(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", ["", "_sharded"], ids=["one", "sharded"])
def test_datasets_are_read_across_packages_bit_for_bit(datasets, kind):
    jpath, tpath = datasets["jax" + kind], datasets["port" + kind]
    js, ts = shards(jpath), shards(tpath)
    assert set(js) == set(ts) and len(js) == (2 if kind else 1)
    assert all(same_arrays(ts[f], js[f]) for f in js)
    with open(os.path.join(jpath, "meta.json")) as f, \
            open(os.path.join(tpath, "meta.json")) as g:
        assert f.read() == g.read()
    # each package reads the other's directory
    for reader, path in ((toff, jpath), (joff, tpath)):
        ds, ref = reader.OfflineDataset(path), joff.OfflineDataset(jpath)
        assert ds.size == ref.size == 2000
        assert same_arrays(ds.data, ref.data)
        got = list(ds.minibatches(256, np.random.default_rng(1)))
        want = list(ref.minibatches(256, np.random.default_rng(1)))
        assert len(got) == len(want) == 7
        assert all(same_arrays(g, w) for g, w in zip(got, want))
    # control: another generator
    assert not same_arrays(
        next(toff.OfflineDataset(jpath).minibatches(
            256, np.random.default_rng(2))),
        next(joff.OfflineDataset(jpath).minibatches(
            256, np.random.default_rng(1))))
    with open(os.path.join(tpath, "meta.json")) as f:
        assert json.load(f)["fields"] == list(toff.FIELDS)


def test_dataset_writer_shards(tmp_path):
    w = toff.DatasetWriter(str(tmp_path / "sh"), shard_size=100)
    for _ in range(3):
        w.write({"obs": np.zeros((80, 2), np.float32),
                 "actions": np.zeros((80,), np.int32),
                 "rewards": np.zeros((80,), np.float32),
                 "next_obs": np.zeros((80, 2), np.float32),
                 "dones": np.zeros((80,), np.float32)})
    w.close()
    assert toff.OfflineDataset(str(tmp_path / "sh")).size == 240
    assert len(shards(str(tmp_path / "sh"))) == 3


def test_missing_dataset_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        toff.OfflineDataset(str(tmp_path))


# ---------------------------------------------------------------------------
# The updates
# ---------------------------------------------------------------------------

def first_batch(path, size=256):
    return next(joff.OfflineDataset(path).minibatches(
        size, np.random.default_rng(0)))


def test_bc_update_matches_jax(datasets):
    jalgo = joff.BCConfig(input_path=datasets["jax"]).build()
    params = np_tree(jalgo.params)
    batch = first_batch(datasets["jax"])
    new, _, loss = jalgo._update(jalgo.params, jalgo.opt_state,
                                 batch["obs"], batch["actions"])

    def port(actions):
        m = module(params)
        tx = adam(1e-3)
        opt = tx.init(dict(m.named_parameters()))
        b = to_device({**batch, "actions": actions}, "cpu")
        got = toff._bc_update(m, opt, b, tx=tx)
        return m.numpy_tree(), float(got)

    got, got_loss = port(batch["actions"])
    assert tree_err(got, np_tree(new)) < TOL
    assert rel_err(got_loss, float(loss)) < TOL
    # control: the logged actions flipped
    assert tree_err(port(1 - batch["actions"])[0], np_tree(new)) > TOL


@pytest.mark.parametrize("cql_alpha", [1.0, 0.5])
def test_cql_update_matches_jax(datasets, cql_alpha):
    jalgo = joff.CQLConfig(input_path=datasets["jax"],
                           cql_alpha=cql_alpha).build()
    params = np_tree(jalgo.params)
    # a target other than the online network
    target = np_tree(jppo.init_module(jax.random.key(3), 4, 2, 64))
    batch = first_batch(datasets["jax"])
    new, _, loss, td, cons = jalgo._update(
        jalgo.params, jalgo.opt_state, jax.tree.map(jnp.asarray, target),
        batch)

    def port(alpha):
        m = module(params)
        tx = adam(1e-3)
        opt = tx.init(dict(m.named_parameters()))
        stats = toff._cql_update(m, opt, frozen_copy(module(target)),
                                 to_device(batch, "cpu"), tx=tx, gamma=0.99,
                                 alpha=alpha)
        return m.numpy_tree(), [float(x) for x in stats]

    got, stats = port(cql_alpha)
    assert tree_err(got, np_tree(new)) < TOL
    assert rel_err(stats, [float(loss), float(td), float(cons)]) < TOL
    # control: another regularizer weight
    assert tree_err(port(cql_alpha * 2)[0], np_tree(new)) > TOL


def marwil_batch(data, n=256, seed=0):
    sel = np.random.default_rng(seed).permutation(len(data["obs"]))[:n]
    return {k: v[sel] for k, v in data.items()}


def test_marwil_update_matches_jax(datasets):
    jalgo = jmarwil.MARWILConfig(input_path=datasets["jax"]).build()
    params = np_tree(jalgo.params)
    batch = marwil_batch(jalgo.data)
    kw = dict(beta=1.0, vf_coeff=1.0)
    norm = 0.5   # a small normaliser: some weights reach their clip
    tx = optax.adam(1e-3)
    new, _, stats = jmarwil._marwil_update(
        jalgo.params, tx.init(jalgo.params),
        {k: jnp.asarray(v) for k, v in batch.items()}, sqd_adv_norm=norm,
        tx=tx, **kw)

    def port(**over):
        m = module(params)
        ptx = adam(1e-3)
        opt = ptx.init(dict(m.named_parameters()))
        got = tmarwil._marwil_update(m, opt, to_device(batch, "cpu"),
                                     sqd_adv_norm=norm, tx=ptx,
                                     **{**kw, **over})
        return m.numpy_tree(), {k: float(v) for k, v in got.items()}

    got, got_stats = port()
    assert tree_err(got, np_tree(new)) < TOL
    assert max(rel_err(got_stats[k], float(stats[k])) for k in stats) < TOL
    # the clip binds on some rows
    logits, values = jppo._np_forward(params, batch["obs"])
    adv = batch["returns"] - values
    assert (np.exp(adv / np.sqrt(norm + 1e-8)) > 20).any()
    # control: another temperature
    assert tree_err(port(beta=0.5)[0], np_tree(new)) > TOL


# ---------------------------------------------------------------------------
# Whole epochs and iterations
# ---------------------------------------------------------------------------

def test_bc_epochs_match_jax(datasets):
    """Two epochs (14 steps), held within ``floor_bound`` of JAX's own
    difference, its two epochs run op by op."""
    jalgo = joff.BCConfig(input_path=datasets["jax"]).build()
    params = np_tree(jalgo.params)
    want = [jalgo.train() for _ in range(2)]
    jfloor = joff.BCConfig(input_path=datasets["jax"]).build()
    with jax.disable_jit():
        floor = [jfloor.train() for _ in range(2)]
    bound = floor_bound(max(
        [tree_err(np_tree(jfloor.params), np_tree(jalgo.params))]
        + [rel_err(f["loss"], w["loss"]) for f, w in zip(floor, want)]))
    for lr in (1e-3, 2e-3):
        algo = toff.BCConfig(input_path=datasets["jax"], device="cpu",
                             lr=lr).build()
        algo.params = module(params)
        got = [algo.train() for _ in range(2)]
        errs = [rel_err(g["loss"], w["loss"]) for g, w in zip(got, want)]
        errs.append(tree_err(algo.params.numpy_tree(), np_tree(jalgo.params)))
        if lr == 1e-3:
            assert all(g["num_samples_trained"] == 2000 for g in got)
            assert max(errs) < bound, (errs, bound)
        else:   # control: another learning rate
            assert max(errs) > bound, (errs, bound)


def test_cql_epochs_match_jax(datasets):
    """Two epochs of 7 minibatches: the target syncs at the 8th, in the
    second epoch."""
    jalgo = joff.CQLConfig(input_path=datasets["jax"]).build()
    params = np_tree(jalgo.params)
    want = [jalgo.train() for _ in range(2)]
    for every in (8, 7):
        algo = toff.CQLConfig(input_path=datasets["jax"], device="cpu",
                              target_update_every=every).build()
        algo.params = module(params)
        algo.target_params = frozen_copy(module(params))
        got = [algo.train() for _ in range(2)]
        errs = [rel_err(g[k], w[k]) for g, w in zip(got, want)
                for k in ("loss", "td_loss", "cql_loss")]
        errs += [tree_err(algo.params.numpy_tree(), np_tree(jalgo.params)),
                 tree_err(algo.target_params.numpy_tree(),
                          np_tree(jalgo.target_params))]
        if every == 8:
            assert algo._updates == 14
            assert max(errs) < TOL, errs
        else:   # control: the target synced a minibatch early
            assert max(errs) > TOL, errs


def test_marwil_iterations_match_jax(datasets, tmp_path):
    path = str(tmp_path / "marwil.pkl")
    jalgo = jmarwil.MARWILConfig(input_path=datasets["jax"]).build()
    jalgo.save(path)
    want = [jalgo.train() for _ in range(5)]
    for decay in (0.99, 0.5):
        algo = tmarwil.MARWILConfig(input_path=datasets["jax"], device="cpu",
                                    adv_norm_decay=decay).build()
        algo.restore(path)
        assert all(np.array_equal(algo.data[k], jalgo.data[k])
                   for k in jalgo.data)
        got = [algo.train() for _ in range(5)]
        errs = [rel_err(g[k], w[k]) for g, w in zip(got, want)
                for k in ("policy_loss", "vf_loss", "mean_adv_weight")]
        errs += [tree_err(algo.params.numpy_tree(), np_tree(jalgo.params)),
                 rel_err(algo._sqd_adv_norm, jalgo._sqd_adv_norm)]
        if decay == 0.99:
            assert max(errs) < TOL, errs
        else:   # control: another moving average
            assert max(errs) > TOL, errs


def test_marwil_port_checkpoint_restores_into_jax(datasets, tmp_path):
    path = str(tmp_path / "marwil.pkl")
    algo = tmarwil.MARWILConfig(input_path=datasets["jax"],
                                device="cpu").build()
    algo.train()
    algo.save(path)
    jalgo = jmarwil.MARWILConfig(input_path=datasets["jax"]).build()
    jalgo.restore(path)
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    assert all(jalgo.compute_action(o) == algo.compute_action(o)
               for o in obs)


# ---------------------------------------------------------------------------
# Off-policy estimators
# ---------------------------------------------------------------------------

def test_estimators_match_jax(datasets):
    """The same CartPole episodes scored for a uniform behaviour and a
    target policy module (numpy forward), by both packages."""
    ds = joff.OfflineDataset(datasets["jax"])
    params = np_tree(jppo.init_module(jax.random.key(4), 4, 2, 64))

    def behavior(obs, acts):
        return np.log(np.full(len(acts), 0.5))

    def target(obs, acts):
        logits, _ = jppo._np_forward(params, np.asarray(obs, np.float32))
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return logp[np.arange(len(acts)), np.asarray(acts)]

    jeps = jest.episodes_from_dataset(ds)
    teps = test_.episodes_from_dataset(toff.OfflineDataset(datasets["jax"]))
    assert len(teps) == len(jeps) > 50
    assert all(same_arrays(t, j) for t, j in zip(teps, jeps))
    for name in ("ImportanceSampling", "WeightedImportanceSampling"):
        want = getattr(jest, name)(gamma=0.99).estimate(jeps, target,
                                                        behavior)
        assert getattr(test_, name)(gamma=0.99).estimate(
            teps, target, behavior) == want
        # control: another discount
        assert getattr(test_, name)(gamma=0.9).estimate(
            teps, target, behavior) != want


# ---------------------------------------------------------------------------
# Learning (tests/test_rllib_offline.py's and tests/test_rllib_extras.py's
# checks, on the port) and entry points
# ---------------------------------------------------------------------------

def test_collect_and_load_dataset(tmp_path):
    path = toff.collect_dataset("Bandit-v0", str(tmp_path / "ds"),
                                num_steps=500, seed=0)
    ds = toff.OfflineDataset(path)
    assert ds.size == 500 and ds.data["obs"].shape == (500, 2)
    assert set(np.unique(ds.data["actions"])) <= {0, 1}
    batches = list(ds.minibatches(128, np.random.default_rng(0)))
    assert len(batches) == 3 and batches[0]["obs"].shape == (128, 2)


def test_bc_clones_expert(tmp_path):
    path = toff.collect_dataset(
        "Bandit-v0", str(tmp_path / "expert"), num_steps=1000,
        policy=lambda obs: 1 if obs[0] > 0 else 0, seed=0)
    algo = toff.BCConfig(device="cpu").environment("Bandit-v0").offline_data(
        path).training(lr=3e-3).build()
    first = algo.train()["loss"]
    for _ in range(9):
        last = algo.train()
    assert last["loss"] < first
    score = algo.evaluate(num_episodes=50)["episode_return_mean"]
    assert score > 0.9, f"BC failed to clone the expert: {score}"


def test_cql_learns_from_random_data(tmp_path):
    path = toff.collect_dataset("Bandit-v0", str(tmp_path / "random"),
                                num_steps=2000, seed=0)
    algo = toff.CQLConfig(device="cpu").environment(
        "Bandit-v0").offline_data(path).training(
        lr=3e-3, gamma=0.0, cql_alpha=0.5).build()
    for _ in range(10):
        result = algo.train()
    assert np.isfinite(result["td_loss"]) and np.isfinite(result["cql_loss"])
    score = algo.evaluate(num_episodes=50)["episode_return_mean"]
    assert score > 0.9, f"CQL failed to beat the behavior policy: {score}"


def test_marwil_beats_random_behavior(tmp_path):
    path = toff.collect_dataset("CartPole-v1", str(tmp_path / "ds"),
                                num_steps=4000, seed=0)
    algo = tmarwil.MARWILConfig(device="cpu").environment(
        "CartPole-v1").offline_data(path).training(
        lr=3e-3, beta=1.0, batch_size=512).build()
    for _ in range(150):
        result = algo.train()
    assert np.isfinite(result["policy_loss"])
    assert algo.evaluate(10)["episode_return_mean"] >= 35.0


def test_marwil_beta_zero_is_bc(tmp_path):
    path = toff.collect_dataset("Bandit-v0", str(tmp_path / "ds"),
                                num_steps=512, seed=1)
    algo = tmarwil.MARWILConfig(device="cpu").environment(
        "Bandit-v0").offline_data(path).training(beta=0.0).build()
    assert algo.train()["mean_adv_weight"] == pytest.approx(1.0)


def test_ope_estimators():
    rng = np.random.default_rng(0)
    n = 512
    actions = rng.integers(0, 2, n)
    data = {"obs": np.zeros((n, 1), np.float32), "actions": actions,
            "rewards": (actions == 1).astype(np.float64),
            "next_obs": np.zeros((n, 1), np.float32), "dones": np.ones(n)}
    episodes = test_.episodes_from_dataset(data)
    assert len(episodes) == n

    def behavior_logp(obs, acts):
        return np.log(np.full(len(acts), 0.5))

    def target_logp(obs, acts):
        return np.log(np.where(np.asarray(acts) == 1, 0.9, 0.1))

    is_est = test_.ImportanceSampling(gamma=1.0).estimate(
        episodes, target_logp, behavior_logp)
    wis_est = test_.WeightedImportanceSampling(gamma=1.0).estimate(
        episodes, target_logp, behavior_logp)
    assert 0.4 < is_est["v_behavior"] < 0.6
    assert is_est["v_target"] > 0.8
    assert 0.8 < wis_est["v_target"] <= 1.0
    assert wis_est["effective_sample_size"] > 10


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    """The learners default to device "cuda" and raise without a card,
    before reading any dataset."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cfg in (toff.BCConfig(), toff.CQLConfig(),
                tmarwil.MARWILConfig()):
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cfg.build()
