"""The port's recurrent core (``ray_tpu_torch/rllib/recurrent.py`` and
IMPALA's ``cell``) against the JAX package's on the CPU.

Inputs come from numpy generators with fixed seeds; weights from JAX's
``init_recurrent_module``, carried over by
``convert.recurrent_from_numpy``. Each parity check has a control that
must miss:

- ``_cell_step`` and ``forward_recurrent_seq`` for gru and lstm on
  fragments with episode ends inside them, within 1e-6 of the largest
  entry (control: the dones not shifted, so the state resets one step
  late);
- ``_rppo_update`` (masked surrogate, Adam) against JAX's jitted update
  with ``optax.adam``, from fresh moments and again from JAX's stepped
  parameters and moments through the converter, the stepped parameters
  and the stats within 1e-5 (control: ``clip_eps``);
- the recurrent ``_impala_grads`` for both cells, gradients and stats
  within 1e-5 (control: ``h0`` zeroed);
- ``MemoryCueEnv`` and ``StatelessCartPole``, 200 seeded actions, bit
  for bit (control: another seed);
- the recurrent rollout worker's fragments and IMPALA's recurrent
  trajectory worker, bit for bit (control: another seed).

Then the learning checks of ``tests/test_recurrent.py`` on the port, with
JAX's early stops. No JAX runtime starts here.
"""

import copy
from functools import partial

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import recurrent as jrec
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import recurrent as trec
from ray_tpu_torch.rllib.dqn import to_device
from ray_tpu_torch.rllib.learner_group import loss_grads
from ray_tpu_torch.rllib.ppo import adam
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5
FWD_TOL = 1e-6
CELLS = ("gru", "lstm")
LAYERS = ("enc", "cell", "pi", "vf")


def jax_tree(obs_dim, n_actions, cell, hidden=8, seed=0) -> dict:
    """JAX's module as a numpy tree, ``cell_type`` included."""
    full = jrec.init_recurrent_module(jax.random.key(seed), obs_dim,
                                      n_actions, hidden, cell)
    return {k: v if k == "cell_type" else jax.tree.map(np.asarray, v)
            for k, v in full.items()}


def weights(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "cell_type"}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got: dict, want: dict) -> float:
    return max(rel_err(got[k][leaf], want[k][leaf])
               for k in LAYERS for leaf in ("w", "b"))


def grads_err(module, grads: list, want: dict) -> float:
    """The port's gradients (in ``module.parameters()`` order) against
    JAX's gradient tree, leaf by leaf."""
    return max(rel_err(g.numpy(), want[name.split(".")[0]][
        name.split(".")[1]]) for (name, _), g in zip(
            module.named_parameters(), grads, strict=True))


def stats_err(got: dict, want: dict) -> float:
    return max(rel_err(float(got[k]), float(want[k])) for k in want)


def sequences(cell, B=4, T=10, obs_dim=3, hidden=8, seed=1) -> dict:
    """[B, T] fragments whose dones fall inside them (and at the end of
    one), a random initial state."""
    rng = np.random.default_rng(seed)
    size = 2 * hidden if cell == "lstm" else hidden
    dones = np.zeros((B, T), np.float32)
    dones[0, 3] = dones[1, 5] = dones[2, 1] = dones[2, 6] = 1.0
    dones[3, T - 1] = 1.0
    return {"obs": rng.standard_normal((B, T, obs_dim)).astype(np.float32),
            "h0": rng.standard_normal((B, size)).astype(np.float32),
            "dones": dones}


# ---------------------------------------------------------------------------
# The cell and the sequence forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_step_and_sequence_forward_match_jax(cell):
    tree = jax_tree(3, 2, cell)
    module = convert.recurrent_from_numpy(tree, device="cpu")
    s = sequences(cell)
    x = np.tanh(s["obs"][:, 0] @ tree["enc"]["w"] + tree["enc"]["b"])
    want = jrec._cell_step(tree, jax.numpy.asarray(x), s["h0"], jax.numpy)
    got = trec._cell_step(module.tree(), torch.from_numpy(x),
                          torch.from_numpy(s["h0"]), torch)
    assert max(rel_err(g.detach(), w) for g, w in zip(got, want)) < FWD_TOL

    want = jax_forward(tree, s["obs"], s["h0"], s["dones"])

    def port(dones):
        with torch.no_grad():
            return trec.forward_recurrent_seq(
                module.tree(), torch.from_numpy(s["obs"]),
                torch.from_numpy(s["h0"]), torch.from_numpy(dones))

    err = max(rel_err(g, w) for g, w in zip(port(s["dones"]), want))
    assert err < FWD_TOL, err
    # control: the dones not shifted (fed shifted left, the forward's own
    # shift cancels): the state resets one step late
    unshifted = np.concatenate([s["dones"][:, 1:],
                                np.zeros_like(s["dones"][:, :1])], axis=1)
    assert max(rel_err(g, w) for g, w in zip(port(unshifted), want)) \
        > FWD_TOL


def jax_forward(tree: dict, *args):
    """JAX's jitted sequence forward; the cell type stays a string in
    the closure, so jit sees arrays only."""
    cell = tree["cell_type"]
    return jax.jit(lambda w, *a: jrec.forward_recurrent_seq(
        {**w, "cell_type": cell}, *a))(weights(tree), *args)


def test_np_recurrent_step_is_the_numpy_copy():
    for cell in CELLS:
        tree = jax_tree(3, 2, cell)
        s = sequences(cell)
        want = jrec.np_recurrent_step(tree, s["obs"][:, 0], s["h0"])
        got = trec.np_recurrent_step(tree, s["obs"][:, 0], s["h0"])
        assert all(np.array_equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want))
        assert trec.state_size(tree) == jrec.state_size(tree)


def test_init_and_converter():
    module = trec.init_recurrent_module(0, 3, 2, 8, "lstm", device="cpu")
    assert [tuple(p.shape) for p in module.parameters()] == [
        (3, 8), (8,), (16, 32), (32,), (8, 2), (2,), (8, 1), (1,)]
    assert trec.state_size(module.tree()) == 16
    again = trec.init_recurrent_module(0, 3, 2, 8, "lstm", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(module.parameters(),
                                                 again.parameters()))
    with pytest.raises(ValueError, match="cell must be"):
        trec.init_recurrent_module(0, 3, 2, 8, "rnn", device="cpu")
    tree = jax_tree(3, 2, "gru")
    # a gru tree read as lstm: the fused weight has 3 gate blocks, not 4
    with pytest.raises(ValueError, match="shapes"):
        convert.recurrent_from_numpy(weights(tree), cell_type="lstm",
                                     device="cpu")
    with pytest.raises(ValueError, match="cell_type"):
        convert.recurrent_from_numpy(tree, cell_type="lstm", device="cpu")
    with pytest.raises(ValueError, match="not a recurrent tree"):
        convert.recurrent_from_numpy({**tree, "extra": tree["pi"]},
                                     device="cpu")
    back = convert.recurrent_from_numpy(weights(tree), cell_type="gru",
                                        device="cpu")
    assert tree_err(back.numpy_tree(), tree) == 0.0


# ---------------------------------------------------------------------------
# RecurrentPPO's update
# ---------------------------------------------------------------------------

def rppo_batch(tree, cell, seed=2) -> dict:
    """Padded fragments (some steps masked) whose ratios leave both clips:
    the behaviour log-probabilities are the policy's own plus noise."""
    s = sequences(cell, seed=seed)
    B, T = s["dones"].shape
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, 7:] = mask[3, 4:] = 0.0
    logits, _, _ = jax_forward(tree, s["obs"], s["h0"], s["dones"])
    actions = rng.integers(0, 2, (B, T)).astype(np.int32)
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                              actions[..., None], -1)[..., 0]
    batch = {**s, "actions": actions, "mask": mask,
             "logp": (logp + 0.4 * rng.standard_normal((B, T))).astype(
                 np.float32),
             "advantages": rng.standard_normal((B, T)).astype(np.float32),
             "returns": rng.standard_normal((B, T)).astype(np.float32)}
    return trec.normalize_masked(batch)


KW = dict(clip_eps=0.2, entropy_coeff=0.01, vf_coeff=0.5)


@pytest.mark.parametrize("cell", CELLS)
def test_rppo_update_matches_jax(cell):
    """One step from fresh moments, then a second on another batch from
    JAX's stepped parameters and Adam moments, carried over by the
    converter (the moments have the parameters' structure)."""
    tree = jax_tree(3, 2, cell)
    batches = [rppo_batch(tree, cell, seed) for seed in (2, 5)]
    tx = optax.adam(1e-2)
    update = jax.jit(partial(jrec._rppo_update, tx=tx, cell=cell, **KW))
    w = jax.tree.map(jax.numpy.asarray, weights(tree))
    jp, jopt, jstats = update(w, tx.init(w), batches[0])
    jp2, _, jstats2 = update(jp, jopt, batches[1])

    def moments(state) -> dict:
        """JAX's ``optax.adam`` state as the port's ``AdamW`` state."""
        adam_state = state[0]
        mods = [convert.recurrent_from_numpy(
            jax.tree.map(np.asarray, m), cell_type=cell, device="cpu")
            for m in (adam_state.mu, adam_state.nu)]
        return {"count": int(adam_state.count),
                **{k: {n: t.detach() for n, t in mod.named_parameters()}
                   for k, mod in zip(("mu", "nu"), mods)}}

    def port(params, opt, batch, **over):
        module = convert.recurrent_from_numpy(params, cell_type=cell,
                                              device="cpu")
        ptx = adam(1e-2)
        # a copy: the step advances the state in place
        opt = copy.deepcopy(opt) if opt else ptx.init(
            dict(module.named_parameters()))
        stats = trec._rppo_update(module, opt, to_device(batch, "cpu"),
                                  tx=ptx, **{**KW, **over})
        return module.numpy_tree(), stats

    for params, opt, batch, want, want_stats in (
            (tree, None, batches[0], jp, jstats),
            (jax.tree.map(np.asarray, jp), moments(jopt), batches[1], jp2,
             jstats2)):
        want = jax.tree.map(np.asarray, want)
        got, stats = port(params, opt, batch)
        errs = (tree_err(got, want), stats_err(stats, want_stats))
        assert max(errs) < TOL, errs
        # control: another clip
        assert tree_err(port(params, opt, batch, clip_eps=0.05)[0],
                        want) > TOL


# ---------------------------------------------------------------------------
# IMPALA's recurrent loss
# ---------------------------------------------------------------------------

IMPALA_KW = dict(gamma=0.99, rho_clip=1.0, c_clip=1.0, entropy_coeff=0.01,
                 vf_coeff=0.5)


def impala_batch(cell, seed=3) -> dict:
    s = sequences(cell, obs_dim=4, seed=seed)
    B, T = s["dones"].shape
    rng = np.random.default_rng(seed)
    return {**s,
            "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
            "behavior_logits": rng.standard_normal((B, T, 2)).astype(
                np.float32),
            "rewards": rng.standard_normal((B, T)).astype(np.float32),
            "bootstrap_obs": rng.standard_normal((B, 4)).astype(np.float32)}


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_impala_grads_match_jax(cell):
    tree = jax_tree(4, 2, cell)
    batch = impala_batch(cell)
    jgrads, jstats = jax.jit(partial(jimpala._impala_grads, cell=cell,
                                     **IMPALA_KW))(
        jax.tree.map(jax.numpy.asarray, weights(tree)), batch)
    jgrads = jax.tree.map(np.asarray, jgrads)

    def port(b):
        module = convert.recurrent_from_numpy(tree, device="cpu")
        grads, stats = loss_grads(partial(timpala.impala_loss, cell=cell,
                                          **IMPALA_KW),
                                  module, to_device(b, "cpu"))
        return grads_err(module, grads, jgrads), stats_err(stats, jstats)

    errs = port(batch)
    assert max(errs) < TOL, errs
    # control: each trajectory's recorded initial state dropped
    assert min(port({**batch, "h0": np.zeros_like(batch["h0"])})) > TOL


# ---------------------------------------------------------------------------
# Environments and rollout workers, bit for bit
# ---------------------------------------------------------------------------

def roll(env, seed, steps=200):
    rng = np.random.default_rng(seed)
    out = [env.reset()]
    for _ in range(steps):
        obs, r, d, _ = env.step(int(rng.integers(2)))
        out += [obs, np.float64(r), np.bool_(d)]
        if d:
            out.append(env.reset())
    return out


def same_roll(a, b) -> bool:
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["MemoryCueEnv", "StatelessCartPole"])
def test_memory_envs_match_jax_bit_for_bit(name):
    want = roll(getattr(jrec, name)(seed=7), 7)
    assert same_roll(roll(getattr(trec, name)(seed=7), 7), want)
    # control: another seed
    assert not same_roll(roll(getattr(trec, name)(seed=8), 8), want)


def same_batch(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k] == b[k] if isinstance(a[k], list) else
        (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
        for k in a)


@pytest.mark.parametrize("cell", CELLS)
def test_rollout_workers_sample_jax_fragments_bit_for_bit(cell):
    tree = jax_tree(2, 2, cell)
    jw = jrec._RecurrentRolloutWorker(jrec.MemoryCueEnv, 1000, 4)
    tw = trec._RecurrentRolloutWorker(trec.MemoryCueEnv, 1000, 4)
    for _ in range(2):
        got = tw.sample(tree, 64, 0.99, 0.95)
        want = jw.sample(tree, 64, 0.99, 0.95)
        assert same_batch(got, want)
    assert set(got) == set(trec.BATCH_KEYS) | {"episode_returns"}
    assert not same_batch(
        trec._RecurrentRolloutWorker(trec.MemoryCueEnv, 1001, 4).sample(
            tree, 64, 0.99, 0.95), want)
    # IMPALA's trajectory worker carries its state across unrolls
    cart = jax_tree(4, 2, cell)
    jt = jimpala._TrajectoryWorker("CartPole-v1", 2000, 2, cell)
    tt = timpala._TrajectoryWorker("CartPole-v1", 2000, 2, cell)
    for _ in range(3):
        got, want = tt.sample(cart, 32), jt.sample(cart, 32)
        assert same_batch(got, want) and "h0" in got
    assert np.abs(got["h0"]).max() > 0
    assert not same_batch(timpala._TrajectoryWorker(
        "CartPole-v1", 2001, 2, cell).sample(cart, 32), want)


# ---------------------------------------------------------------------------
# Learning (tests/test_recurrent.py's checks, on the port)
# ---------------------------------------------------------------------------

def best_return(algo, target, iters) -> float:
    best = -np.inf
    for _ in range(iters):
        best = max(best, algo.train()["episode_return_mean"])
        if best >= target:
            break
    return best


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_ppo_learns_memory_env(cell):
    algo = (trec.RecurrentPPOConfig(device="cpu")
            .environment(trec.MemoryCueEnv)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(cell=cell, max_seq_len=4, lr=5e-3, hidden=32,
                      num_sgd_iter=4, seed=0)
            .build())
    # memoryless ceiling is 0.5; >=0.9 proves the cue is remembered
    best = best_return(algo, 0.9, 40)
    assert best >= 0.9, f"{cell} failed to learn memory task: {best}"
    action, state = algo.compute_action([1.0, 0.0])
    assert action in (0, 1) and state.shape == (1, 32 * (1 + (cell == "lstm")))


def test_impala_recurrent_learns_memory_env():
    algo = (timpala.IMPALAConfig(device="cpu")
            .environment(trec.MemoryCueEnv)
            .rollouts(num_rollout_workers=1, num_envs_per_worker=8)
            .training(cell="gru", unroll_length=32, lr=5e-3, hidden=32,
                      seed=0)
            .build())
    best = best_return(algo, 0.9, 60)
    assert best >= 0.9, f"recurrent IMPALA failed on memory: {best}"
