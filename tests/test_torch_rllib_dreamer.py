"""The port's DreamerV3 (``ray_tpu_torch/rllib/dreamer.py``) against the
JAX package's on the CPU, at ``tests/test_dreamer.py``'s small config.

Weights come from JAX's ``init_dreamer``, carried over by
``convert.dreamer_from_numpy``. Noise is an input of the port's update:
JAX samples its categoricals inside the jit as the argmax of ``logits +
gumbel(key)``, so the tests rebuild JAX's Gumbel draws from JAX's own key
chain (``jax_gumbels``) and feed them in. Each parity check has a control
that must miss:

- ``symlog``/``symexp``, ``_kl_cats`` and ``_sample_onehot`` (the one-hot
  and its straight-through gradient, the 1% unimix), within 1e-6
  (control: the unimix left out);
- ``_dreamer_update`` against JAX's jitted update, from fresh optimizer
  states and again from JAX's stepped state (parameters, target, Adam
  moments through the converter, return scale): every leaf of the
  world model, actor and critic, the target critic, ``ret_scale`` and the
  metrics within 1e-5 of each leaf's largest entry, at the default free
  bits (control: gamma 0.9) and at none, where the KL terms' gradients
  are not clamped away (control: ``kl_dyn`` and ``kl_rep`` swapped).
  Every sampled index equals JAX's (read from a
  second compile of JAX's update that reports its draws); the smallest
  gap between a draw's two largest entries is reported beside, since one
  flipped argmax changes a one-hot;
- ``SequenceReplay`` (writer joints, a ring wrap) and the rollout worker
  (terminal and truncated ends), bit for bit (control: another seed);
- the greedy filtered action of ``compute_single_action``.

Then ``tests/test_dreamer.py``'s checks on the port. No JAX runtime
starts here (whole iterations are in ``test_torch_rllib_more_runs.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import dreamer as jdr
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import dreamer as tdr
from ray_tpu_torch.rllib.dqn import init_opt_state, to_device
from ray_tpu_torch.rllib.sac import leaves
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-5
OBS, ACTS = 4, 2
SMALL = dict(embed=16, h_dim=32, n_cats=4, n_classes=4, hidden=32)
SEQ, BATCH, HORIZON = 12, 4, 6
# cfg_s: n_actions, n_cats, n_classes, h_dim, horizon, gamma, lam,
# entropy_coef, free_nats, kl_dyn, kl_rep, tau (DreamerV3Config's)
CFG_S = (ACTS, 4, 4, 32, HORIZON, 0.997, 0.95, 3e-3, 1.0, 0.5, 0.1, 0.02)
LR_WM, LR_ACTOR, LR_CRITIC = 1e-3, 3e-4, 3e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def port_leaves(tree: dict) -> list:
    """A numpy DreamerV3 tree's leaves in the port's order."""
    return [x.detach().numpy() for x in leaves(convert.dreamer_from_numpy(
        tree, device="cpu"))]


def tree_err(got: list, want: dict) -> float:
    return max(rel_err(g.detach().numpy(), w)
               for g, w in zip(got, port_leaves(want), strict=True))


def jax_gumbels(key, b=BATCH, t=SEQ, horizon=HORIZON, n_cats=4,
                n_classes=4, n_actions=ACTS) -> dict:
    """The Gumbel draws JAX's ``_dreamer_update`` makes from ``key``:
    ``k_wm, k_img = split(key)``; each posterior step ``k, ks =
    split(k)``; each imagination step's key of ``split(k_img, horizon)``
    split into the action's and the prior's."""
    k_wm, k_img = jax.random.split(key)
    post, k = [], k_wm
    for _ in range(t):
        k, ks = jax.random.split(k)
        post.append(jax.random.gumbel(ks, (b, n_cats, n_classes)))
    act, prior = [], []
    for kk in jax.random.split(k_img, horizon):
        ka, kz = jax.random.split(kk)
        act.append(jax.random.gumbel(ka, (b * t, n_actions)))
        prior.append(jax.random.gumbel(kz, (b * t, n_cats, n_classes)))
    return {"post": np.stack(post), "act": np.stack(act),
            "prior": np.stack(prior)}


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_symlog_symexp_and_kl_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(64) * 30).astype(np.float32)
    for name in ("symlog", "symexp"):
        want = np.asarray(getattr(jdr, name)(x / (10 if name == "symexp"
                                                  else 1)))
        got = getattr(tdr, name)(torch.from_numpy(x / (10 if name ==
                                                      "symexp" else 1)))
        assert rel_err(got, want) < 1e-6, name
    np.testing.assert_array_equal(tdr._np_symlog(x), jdr._np_symlog(x))
    a = rng.standard_normal((5, 16)).astype(np.float32)
    b = rng.standard_normal((5, 16)).astype(np.float32)
    want = np.asarray(jdr._kl_cats(a, b, 4, 4))
    got = tdr._kl_cats(torch.from_numpy(a), torch.from_numpy(b), 4, 4)
    assert rel_err(got, want) < 1e-6
    # control: the arguments swapped (KL is not symmetric)
    assert rel_err(tdr._kl_cats(torch.from_numpy(b), torch.from_numpy(a),
                                4, 4), want) > 1e-6


def test_sample_onehot_value_and_straight_through_gradient():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal((6, 16)).astype(np.float32)
    key = jax.random.key(4)
    g = np.array(jax.random.gumbel(key, (6, 4, 4)))

    def jax_fn(lg):
        return jnp.sum(jdr._sample_onehot(lg, key, 4, 4) * w)

    want_v = np.asarray(jdr._sample_onehot(logits, key, 4, 4))
    want_g = np.asarray(jax.grad(jax_fn)(logits))

    def port(unimix=0.01):
        lg = torch.from_numpy(logits).requires_grad_()
        record = []
        v = tdr._sample_onehot(lg, torch.from_numpy(g), 4, 4, unimix=unimix,
                               record=record)
        (v * torch.from_numpy(w)).sum().backward()
        return v.detach(), lg.grad, record

    v, grad, record = port()
    assert rel_err(v, want_v) < 1e-6 and rel_err(grad, want_g) < 1e-6
    # one one-hot per category, the indices JAX's categorical draws
    idx = record[0][0].numpy()
    assert np.array_equal(np.asarray(want_v).reshape(6, 4, 4).round()
                          .argmax(-1), idx)
    assert float(record[0][1].min()) > 0
    # control: no unimix moves the straight-through gradient
    assert rel_err(port(unimix=0.0)[1], want_g) > 1e-6


def test_init_and_converter():
    params = tdr.init_dreamer(0, OBS, ACTS, device="cpu", **SMALL)
    jparams = np_tree(jdr.init_dreamer(jax.random.key(0), OBS, ACTS,
                                       **SMALL))
    got = [tuple(x.shape) for x in leaves(params)]
    assert got == [tuple(x.shape) for x in port_leaves(jparams)]
    assert all(x.requires_grad for x in leaves(params))
    again = tdr.init_dreamer(0, OBS, ACTS, device="cpu", **SMALL)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                 leaves(again)))
    # the converter keeps every number and takes a part of the tree
    back = convert.dreamer_from_numpy(jparams, device="cpu")
    assert tree_err(leaves(back), jparams) == 0.0
    assert list(convert.dreamer_from_numpy(
        {"critic": jparams["critic"]}, device="cpu")) == ["critic"]
    bad = {**jparams, "actor": jparams["critic"]}
    with pytest.raises(ValueError, match="actor maps"):
        convert.dreamer_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.dreamer_from_numpy({**jparams, "target": 1}, device="cpu")
    wm = dict(jparams["wm"])
    wm["post"] = wm["prior"]
    with pytest.raises(ValueError, match="widths"):
        convert.dreamer_from_numpy({"wm": wm}, device="cpu")


# ---------------------------------------------------------------------------
# One update against JAX's jitted one
# ---------------------------------------------------------------------------

def replay_batch(params_np: dict, seed=0) -> dict:
    """A [BATCH, SEQ] batch sampled from a replay that JAX's rollout
    worker filled with 160 CartPole steps (episode joints inside)."""
    worker = jdr._DreamerRolloutWorker("CartPole-v1", 1000 + seed,
                                       (ACTS, 4, 4, 32))
    frag = worker.sample({k: params_np["wm"][k]
                          for k in ("encoder", "gru", "post")},
                         params_np["actor"], 160)
    frag.pop("episode_returns")
    replay = jdr.SequenceReplay(1000, OBS)
    replay.add_batch(frag)
    return replay.sample(BATCH, SEQ, np.random.default_rng(seed))


TXS = {"wm": optax.chain(optax.clip_by_global_norm(100.0),
                         optax.adam(LR_WM)),
       "actor": optax.adam(LR_ACTOR), "critic": optax.adam(LR_CRITIC)}


def jax_update(cfg_s, record=None):
    """JAX's update, jitted as ``DreamerV3`` jits it (one compile for the
    test's steps); with ``record`` a compile whose categoricals report
    their indices there."""
    fn = partial(jdr._dreamer_update, cfg_s=cfg_s, tx_wm=TXS["wm"],
                 tx_actor=TXS["actor"], tx_critic=TXS["critic"])
    if record is None:
        return jax.jit(fn)
    categorical = jax.random.categorical

    def reporting(key, logits, axis=-1):
        idx = categorical(key, logits, axis=axis)
        jax.debug.callback(lambda i: record.append(np.asarray(i)), idx,
                           ordered=True)
        return idx

    def traced(*args):
        jax.random.categorical = reporting
        try:
            return fn(*args)
        finally:
            jax.random.categorical = categorical

    return jax.jit(traced)


def port_opt_state(name: str, adam_state) -> dict:
    """JAX's ``ScaleByAdamState`` of one part as the port's optimizer
    state, its moments through the converter in the port's leaf order."""
    mu, nu = ([x.detach() for x in leaves(convert.dreamer_from_numpy(
        {name: np_tree(m)}, device="cpu"))]
        for m in (adam_state.mu, adam_state.nu))
    return {"count": int(adam_state.count),
            "mu": {str(i): m for i, m in enumerate(mu)},
            "nu": {str(i): v for i, v in enumerate(nu)}}


def port_update(params_np, batch, noise, cfg_s, record=None, state=None):
    """The port's update from JAX's numpy tree; ``state``: JAX's target
    critic, its three optimizer states and the return scale (default:
    the critic, fresh states and 1)."""
    from ray_tpu_torch.rllib.ppo import _constant, adam
    from ray_tpu_torch.train.optim import AdamW

    params = convert.dreamer_from_numpy(params_np, device="cpu")
    txs = {"wm": AdamW(partial(_constant, LR_WM), max_grad_norm=100.0,
                       b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0),
           "actor": adam(LR_ACTOR), "critic": adam(LR_CRITIC)}
    if state is None:
        target_np, scale = params_np["critic"], 1.0
        opts = [init_opt_state(txs[k], leaves(params[k]))
                for k in ("wm", "actor", "critic")]
    else:
        target_np, (opt_wm, opt_actor, opt_critic), scale = state
        opts = [port_opt_state("wm", opt_wm[1][0]),
                port_opt_state("actor", opt_actor[0]),
                port_opt_state("critic", opt_critic[0])]
    target = convert.dreamer_from_numpy({"critic": target_np},
                                        device="cpu")["critic"]
    scale, metrics = tdr._dreamer_update(
        params, target, *opts, torch.tensor(float(scale)),
        to_device(batch, "cpu"),
        to_device(noise, "cpu"), cfg_s=cfg_s, tx_wm=txs["wm"],
        tx_actor=txs["actor"], tx_critic=txs["critic"], record=record)
    return params, target, scale, metrics


def swap_kl(cfg_s: tuple) -> tuple:
    return cfg_s[:9] + (cfg_s[10], cfg_s[9]) + cfg_s[11:]


def with_gamma(cfg_s: tuple, gamma: float) -> tuple:
    return cfg_s[:5] + (gamma,) + cfg_s[6:]


# DreamerV3Config's free bits (1 nat) clamp both KL terms of this small
# model, which zeroes their gradients: the KL path is held at free bits 0,
# where its control, the balance swapped, bites; at the default the
# control is the discount
FREE_NATS = {"default": (1.0, lambda c: with_gamma(c, 0.9)),
             "no_free_bits": (0.0, swap_kl)}


@pytest.mark.parametrize("case", sorted(FREE_NATS))
def test_dreamer_update_matches_jax(case):
    """One update from fresh optimizer states, every draw's index equal to
    JAX's; then a second on another batch from JAX's stepped state (its
    parameters, target, Adam moments through the converter, return
    scale)."""
    free_nats, control = FREE_NATS[case]
    cfg_s = CFG_S[:8] + (free_nats,) + CFG_S[9:]
    jparams = jdr.init_dreamer(jax.random.key(0), OBS, ACTS, **SMALL)
    params_np = np_tree(jparams)
    batch = replay_batch(params_np)
    assert batch["is_first"].sum() >= 1
    key = jax.random.key(7)
    args = (jparams, jparams["critic"], TXS["wm"].init(jparams["wm"]),
            TXS["actor"].init(jparams["actor"]),
            TXS["critic"].init(jparams["critic"]), np.float32(1.0), batch,
            key)
    update = jax_update(cfg_s)
    out = update(*args)
    jax_draws = []
    jax.block_until_ready(jax_update(cfg_s, record=jax_draws)(*args))

    def errs(got, want) -> dict:
        params, target, scale, metrics = got
        jp, jt, _, _, _, jscale, jm = want
        assert set(metrics) == set(jm)
        return {"params": tree_err(leaves(params), np_tree(jp)),
                "target": tree_err(leaves(target), {"critic": np_tree(jt)}),
                "ret_scale": rel_err(float(scale), float(jscale)),
                "metrics": max(rel_err(float(metrics[k]), float(jm[k]))
                               for k in jm)}

    record = []
    noise = jax_gumbels(key)
    got = errs(port_update(params_np, batch, noise, cfg_s, record=record),
               out)
    draws = [idx.numpy() for idx, _ in record]
    margin = min(float(m.min()) for _, m in record)
    assert len(draws) == len(jax_draws) == SEQ + 2 * HORIZON
    assert all(np.array_equal(d, w) for d, w in zip(draws, jax_draws)), \
        f"a sampled index differs (smallest margin {margin})"
    assert max(got.values()) < TOL, (got, margin)
    ctl = errs(port_update(params_np, batch, noise, control(cfg_s)), out)
    assert max(ctl.values()) > TOL, ctl

    # the second update, from JAX's state after the first
    key2, batch2 = jax.random.key(8), replay_batch(params_np, seed=1)
    out2 = update(*out[:6], batch2, key2)
    state = (np_tree(out[1]), out[2:5], float(out[5]))
    noise2 = jax_gumbels(key2)
    got2 = errs(port_update(np_tree(out[0]), batch2, noise2, cfg_s,
                            state=state), out2)
    assert max(got2.values()) < TOL, got2
    ctl2 = errs(port_update(np_tree(out[0]), batch2, noise2, control(cfg_s),
                            state=state), out2)
    assert max(ctl2.values()) > TOL, ctl2


# ---------------------------------------------------------------------------
# Replay and rollouts, bit for bit
# ---------------------------------------------------------------------------

def replay_state(rep) -> dict:
    return {k: getattr(rep, k).copy() for k in
            ("obs", "actions", "rewards", "is_first", "cont")} | {
        "pos": rep.pos, "size": rep.size}


def same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k] == b[k] if not isinstance(a[k], np.ndarray) else
        (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
        for k in a)


def test_sequence_replay_and_rollout_worker_match_jax():
    params_np = np_tree(jdr.init_dreamer(jax.random.key(0), OBS, ACTS,
                                         **SMALL))
    wm_np = {k: params_np["wm"][k] for k in ("encoder", "gru", "post")}
    sizes = (ACTS, 4, 4, 32)

    def run(mod, seed):
        workers = [mod._DreamerRolloutWorker("CartPole-v1", seed + i, sizes)
                   for i in range(2)]
        rep = mod.SequenceReplay(300, OBS)
        rng = np.random.default_rng(seed)
        out = []
        # two writers interleave, then the ring wraps
        for _ in range(3):
            for i, w in enumerate(workers):
                frag = w.sample(wm_np, params_np["actor"], 64)
                out.append(frag.pop("episode_returns"))
                out.append(dict(frag))
                rep.add_batch(frag, writer=i)
                out.append(rep.sample(4, 8, rng))
        out.append(replay_state(rep))
        return out

    want = run(jdr, 1000)
    got = run(tdr, 1000)
    assert len(got) == len(want)
    assert all(g == w if isinstance(w, list) else same(g, w)
               for g, w in zip(got, want))
    assert want[-1]["size"] == 300 and want[-1]["is_first"].sum() > 2
    # control: another seed
    assert not all(g == w if isinstance(w, list) else same(g, w)
                   for g, w in zip(run(tdr, 1001), want))


def test_compute_single_action_matches_jax():
    algo = tdr.DreamerV3Config(device="cpu").training(**SMALL).build()
    jparams = np_tree(jdr.init_dreamer(jax.random.key(3), OBS, ACTS,
                                       **SMALL))
    algo.params = convert.dreamer_from_numpy(jparams, device="cpu")
    shell = object.__new__(jdr.DreamerV3)
    shell.params, shell.config, shell.n_actions = \
        jparams, jdr.DreamerV3Config().training(**SMALL), ACTS
    rng = np.random.default_rng(0)
    s_port = s_jax = None
    for _ in range(12):
        obs = rng.standard_normal(OBS).astype(np.float32)
        a, s_port = algo.compute_single_action(obs, s_port)
        b, s_jax = shell.compute_single_action(obs, s_jax)
        assert a == b and all(np.array_equal(x, y)
                              for x, y in zip(s_port, s_jax))


# ---------------------------------------------------------------------------
# tests/test_dreamer.py's checks, on the port
# ---------------------------------------------------------------------------

def small_algo():
    return (tdr.DreamerV3Config(device="cpu")
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=96)
            .training(seq_len=12, batch_size=4, horizon=6,
                      learning_starts=96, num_updates_per_iter=2, seed=0,
                      **SMALL)
            .build())


def test_dreamer_trains_losses_finite_and_world_model_improves():
    import math

    algo = small_algo()
    results = [algo.train() for _ in range(3)]
    last = results[-1]
    assert last["training_iteration"] == 3
    assert last["buffer_size"] >= 96 * 3
    for key in ("wm_loss", "recon_loss", "reward_loss", "cont_loss",
                "kl_loss", "actor_loss", "critic_loss", "policy_entropy"):
        assert math.isfinite(last[key]), (key, last[key])
    assert 0.0 <= last["policy_entropy"] <= math.log(2) + 1e-3
    # repeated updates on a FIXED batch reduce the reconstruction loss
    batch = algo.buffer.sample(4, algo.config.seq_len,
                               np.random.default_rng(42))
    losses = [algo.update(batch, algo._noise())["recon_loss"]
              for _ in range(6)]
    assert losses[-1] < losses[0], losses
    a, state = algo.compute_single_action(np.zeros(OBS, np.float32))
    assert a in (0, 1) and len(state) == 3


def test_dreamer_rejects_continuous_env():
    with pytest.raises(ValueError, match="discrete-action"):
        tdr.DreamerV3Config(device="cpu").environment("Pendulum-v1").build()
