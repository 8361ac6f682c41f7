"""Whole iterations of the port's slice-15 algorithms against the JAX
package's, from the same weights, on the CPU.

JAX's algorithms run their rollout workers (and IMPALA's mesh learners)
on its runtime, which starts once for this module. Each port algorithm
starts from the JAX algorithm's weights (through JAX's save file where
JAX's algorithm restores into a fresh optimizer state, else through the
converters), never from a shared seed; the rollout workers then sample
the same batches, so the results, the stats and the final parameters
are held within 1e-5 of each leaf's largest entry (``floor_bound`` where
JAX's own two compiles differ by more), each with a control that must
miss: the port at discount 0.9 (MultiAgentPPO on one-step episodes:
``clip_eps`` 0.02; ES and ARS: another learning rate).

- RecurrentPPO with gru and with lstm on ``MemoryCueEnv``, 2 iterations;
- IMPALA with ``cell="gru"``, one learner and the LearnerGroup's mesh
  mode with 2 learners, 2 iterations;
- MultiAgentPPO, shared and independent, 2 iterations from JAX's save
  file;
- DreamerV3 at ``tests/test_dreamer.py``'s small config, 2 updating
  iterations, the port's Gumbel draws replaced by JAX's key chain;
- ES and ARS on Bandit-v0, 2 iterations, ``theta`` bit for bit.
"""

import jax
import numpy as np
import pytest

import ray_tpu
from ray_tpu.rllib import dreamer as jdr
from ray_tpu.rllib import es as jes
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import recurrent as jrec
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import dreamer as tdr
from ray_tpu_torch.rllib import es as tes
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib import recurrent as trec
from ray_tpu_torch.rllib.sac import leaves
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5
# JAX's program compiled with LLVM's backend optimisations off: how far
# that run lands from the default compile is JAX's own float32 noise
FLOOR_OPTIONS = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def rt():
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    yield
    ray_tpu.shutdown()


def floor_bound(floor: float) -> float:
    """TOL, or twice JAX's own noise (``FLOOR_OPTIONS``) where that is
    larger."""
    return max(TOL, 2 * floor)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got, want) -> float:
    """The worst leaf's ``rel_err`` over two numpy trees of one structure
    (``cell_type`` tags skipped)."""
    if isinstance(want, dict):
        return max(tree_err(got[k], want[k]) for k in want
                   if k != "cell_type")
    if isinstance(want, list):
        return max(tree_err(g, w) for g, w in zip(got, want, strict=True))
    return rel_err(got, want)


EXACT = ("training_iteration", "num_episodes", "episode_return_mean",
         "num_env_steps_sampled", "episodes_this_iter", "buffer_size")


def result_err(got: list, want: list, keys, case: str) -> float:
    """The worst stat's ``rel_err`` over the iterations' results; the
    counts and the sampled returns must be equal, except in a control,
    whose changed update may sample other episodes after its first
    iteration (they then count in its error)."""
    exact = [k for k in EXACT if k in want[0]]
    for g, w in zip(got, want, strict=True):
        for k in exact:
            assert case == "control" or g[k] == w[k], (k, g[k], w[k])
    return max(rel_err(g[k], w[k]) for g, w in zip(got, want)
               for k in (*keys, *exact))


def held(errs: dict, bound=TOL) -> None:
    assert errs["same"] < bound, errs
    assert errs["control"] > bound, errs


# the port's setting for the run held to JAX's, and for its control
DISCOUNTS = {"same": {}, "control": {"gamma": 0.9}}


# ---------------------------------------------------------------------------
# The recurrent core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_recurrent_ppo_iterations_match_jax(rt, cell):
    kw = dict(cell=cell, max_seq_len=4, hidden=16, lr=5e-3)
    jalgo = (jrec.RecurrentPPOConfig().environment(jrec.MemoryCueEnv)
             .rollouts(rollout_fragment_length=64).training(**kw).build())
    try:
        params0 = jalgo._params_np()
        want = [jalgo.train() for _ in range(2)]
        want_params = jalgo._params_np()
    finally:
        jalgo.stop()
    errs = {}
    for case, over in DISCOUNTS.items():
        algo = (trec.RecurrentPPOConfig(device="cpu", **over)
                .environment(trec.MemoryCueEnv)
                .rollouts(rollout_fragment_length=64).training(**kw).build())
        algo.module = convert.recurrent_from_numpy(params0, device="cpu")
        got = [algo.train() for _ in range(2)]
        errs[case] = max(result_err(got, want, ("policy_loss", "entropy"),
                                    case),
                         tree_err(algo._params_np(), want_params))
        assert algo._params_np()["cell_type"] == cell
    held(errs)


@pytest.mark.parametrize("num_learners", [0, 2])
def test_impala_cell_iterations_match_jax(rt, num_learners):
    kw = dict(cell="gru", hidden=16, unroll_length=32,
              num_learners=num_learners)
    jalgo = jimpala.IMPALAConfig().training(**kw).build()
    try:
        params0 = jalgo._params_np()
        want = [jalgo.train() for _ in range(2)]
        want_params = jalgo._params_np()
    finally:
        jalgo.stop()
    errs = {}
    for case, over in DISCOUNTS.items():
        algo = timpala.IMPALAConfig(device="cpu", **over).training(
            **kw).build()
        algo.learner.set_params(params0)
        got = [algo.train() for _ in range(2)]
        errs[case] = max(
            result_err(got, want, ("policy_loss", "vf_loss", "entropy",
                                   "mean_rho"), case),
            tree_err(algo._params_np(), want_params))
    held(errs)


# ---------------------------------------------------------------------------
# Multi-agent PPO
# ---------------------------------------------------------------------------

def shared(agent_id):
    return "shared"


def own(agent_id):
    return f"p_{agent_id}"


@pytest.mark.parametrize("policies,mapping", [
    (("shared",), shared), (("p_a0", "p_a1"), own)])
def test_multi_agent_ppo_iterations_match_jax(rt, tmp_path, policies,
                                              mapping):
    path = str(tmp_path / "ma.pkl")

    def config(mod, **kw):
        return (mod.MultiAgentPPOConfig(**kw).environment("CoopMatch-v0")
                .multi_agent(policies=list(policies),
                             policy_mapping_fn=mapping)
                .rollouts(rollout_fragment_length=96)
                .training(lr=3e-3, minibatch_size=64, hidden=16))

    jalgo = config(jma).build()
    try:
        jalgo.save(path)
        want = [jalgo.train() for _ in range(2)]
        want_params = jalgo._policies_np()
    finally:
        jalgo.stop()
    errs = {}
    # CoopMatch's episodes are one step long, so the discount cannot bite:
    # the control is another clip
    for case, over in {"same": {}, "control": {"clip_eps": 0.02}}.items():
        algo = config(tma, device="cpu", **over).build()
        algo.restore(path)
        got = [algo.train() for _ in range(2)]
        if case == "same":
            assert [g["policy_ids"] for g in got] == \
                [w["policy_ids"] for w in want]
        errs[case] = max(result_err(got, want, ("policy_loss", "entropy"),
                                    case),
                         tree_err(algo._policies_np(), want_params))
    held(errs)


# ---------------------------------------------------------------------------
# DreamerV3
# ---------------------------------------------------------------------------

SMALL = dict(seq_len=12, batch_size=4, horizon=6, embed=16, h_dim=32,
             n_cats=4, n_classes=4, hidden=32, learning_starts=96,
             num_updates_per_iter=2, seed=0)
DREAMER_KEYS = ("wm_loss", "recon_loss", "reward_loss", "cont_loss",
                "kl_loss", "actor_loss", "critic_loss", "imag_return_mean",
                "policy_entropy")


def jax_key_chain(seed: int, cfg) -> callable:
    """A ``_noise`` drawing JAX's chain: ``key, sub = split(key)`` an
    update from ``key(seed + 1)``, then the update's Gumbels from
    ``sub``."""
    key = jax.random.key(seed + 1)
    n = cfg.batch_size * cfg.seq_len

    def draw():
        nonlocal key
        key, sub = jax.random.split(key)
        k_wm, k_img = jax.random.split(sub)
        post, k = [], k_wm
        for _ in range(cfg.seq_len):
            k, ks = jax.random.split(k)
            post.append(jax.random.gumbel(
                ks, (cfg.batch_size, cfg.n_cats, cfg.n_classes)))
        act, prior = [], []
        for kk in jax.random.split(k_img, cfg.horizon):
            ka, kz = jax.random.split(kk)
            act.append(jax.random.gumbel(ka, (n, 2)))
            prior.append(jax.random.gumbel(kz, (n, cfg.n_cats,
                                                cfg.n_classes)))
        return {"post": np.stack(post), "act": np.stack(act),
                "prior": np.stack(prior)}

    return draw


def dreamer_state(algo) -> list:
    return [x.detach().numpy() for x in
            leaves(algo.params) + leaves(algo.target_critic)]


def jax_state(jalgo) -> list:
    params = convert.dreamer_from_numpy(jax.tree.map(
        np.asarray, jalgo.params), device="cpu")
    target = convert.dreamer_from_numpy({"critic": jax.tree.map(
        np.asarray, jalgo.target_critic)}, device="cpu")
    return [x.detach().numpy() for x in leaves(params) + leaves(target)]


def test_dreamer_iterations_match_jax(rt):
    def jax_run(floor=False):
        jalgo = (jdr.DreamerV3Config().environment("CartPole-v1")
                 .rollouts(rollout_fragment_length=96)
                 .training(**SMALL).build())
        if floor:
            jalgo._update = jax.jit(jalgo._update.__wrapped__,
                                    compiler_options=FLOOR_OPTIONS)
        try:
            params0 = jax.tree.map(np.asarray, jalgo.params)
            results = [jalgo.train() for _ in range(2)]
            return params0, results, jax_state(jalgo)
        finally:
            jalgo.stop()

    params0, want, want_state = jax_run()
    assert all(k in w for w in want for k in DREAMER_KEYS)
    _, floor_results, floor_state = jax_run(floor=True)
    floor = max(result_err(floor_results, want, DREAMER_KEYS, "floor"),
                max(rel_err(g, w) for g, w in zip(floor_state, want_state)))
    errs = {}
    for case, over in DISCOUNTS.items():
        algo = (tdr.DreamerV3Config(device="cpu", **over)
                .environment("CartPole-v1")
                .rollouts(rollout_fragment_length=96)
                .training(**SMALL).build())
        algo.params = convert.dreamer_from_numpy(params0, device="cpu")
        algo.target_critic = convert.dreamer_from_numpy(
            {"critic": params0["critic"]}, device="cpu")["critic"]
        algo._noise = jax_key_chain(SMALL["seed"], algo.config)
        got = [algo.train() for _ in range(2)]
        errs[case] = max(
            result_err(got, want, DREAMER_KEYS, case),
            max(rel_err(g, w) for g, w in zip(dreamer_state(algo),
                                              want_state)))
    held(errs, floor_bound(floor))


# ---------------------------------------------------------------------------
# ES and ARS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ES", "ARS"])
def test_es_and_ars_iterations_match_jax(rt, name):
    def kw(mod, lr):
        return dict(episodes_per_batch=8, max_episode_steps=20,
                    episodes_per_direction=2,
                    lr=lr or getattr(mod, f"{name}Config")().lr)

    jalgo = getattr(jes, f"{name}Config")().environment(
        "Bandit-v0").training(**kw(jes, None)).build()
    try:
        want = [(jalgo.train(), jalgo.theta.copy()) for _ in range(2)]
    finally:
        jalgo.stop()

    def port(lr=None):
        algo = getattr(tes, f"{name}Config")().environment(
            "Bandit-v0").training(**kw(tes, lr)).build()
        return [(algo.train(), algo.theta.copy()) for _ in range(2)]

    got = port()
    assert [g[0] for g in got] == [w[0] for w in want]
    assert all(np.array_equal(g[1], w[1]) and g[1].dtype == w[1].dtype
               for g, w in zip(got, want))
    # control: another learning rate
    assert not all(np.array_equal(g[1], w[1])
                   for g, w in zip(port(lr=0.3), want))
