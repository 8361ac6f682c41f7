"""The port's learner plane (``ray_tpu_torch/rllib/learner_group.py``) and
the harness calls it runs on (``WorkerGroup.execute``, ``execute_async``,
``healthy``), on the CPU.

- Mesh mode with 2 and 3 learners (3 pads a 128-row minibatch to 129)
  against JAX's ``LearnerGroup`` in mesh mode on its 8 CPU devices, from
  the same parameters, on PPO's loss: stats and parameters within 1e-5
  after 3 Adam steps (control: the port's 3 learners against JAX's 1 on
  the unpadded minibatches, which the wrapped row must move).
- Actors mode with 2 gloo rank processes against mesh mode with 2
  learners, as ``tests/test_learner_group.py:67`` holds JAX's planes
  (control: one learner on rank 0's shard alone, as a rank that skipped
  the all-reduce would step); and PPO built with actors mode against PPO
  built with mesh mode over one iteration, and IMPALA with an lstm core
  likewise over two.
- ``WorkerGroup``: results in rank order, ``execute_async``'s calls read
  in any order, ``healthy``, and a rank that raises: the call raises with
  its traceback, the other rank is killed, ``healthy`` turns False.

Every spawn is joined within LIMIT_S and its ranks killed on expiry; no
child process is left.
"""

import multiprocessing
import operator
import threading
from functools import partial

import jax
import numpy as np
import optax
import pytest

from ray_tpu.rllib import learner_group as jlg
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.rllib import learner_group as tlg
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.train.worker_group import WorkerGroup

LIMIT_S = 120.0
TOL = 1e-5
LR = 3e-4
KW = dict(clip_eps=0.2, entropy_coeff=0.01, vf_coeff=0.5)
LAYERS = ("torso1", "torso2", "pi", "vf")


def within_limit(fn):
    """``fn()`` within LIMIT_S: on expiry every child process is killed and
    the test fails. Afterwards no child process is left."""
    box = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        pytest.fail(f"did not finish within {LIMIT_S} s")
    assert multiprocessing.active_children() == []
    if "error" in box:
        raise box["error"]
    return box.get("result")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def tree_err(got: dict, want: dict) -> float:
    return max(rel_err(got[k][leaf], want[k][leaf])
               for k in LAYERS for leaf in ("w", "b"))


def run_err(got, want) -> float:
    """The worst error over a run's stats and its final parameters."""
    (g_stats, g_params), (w_stats, w_params) = got, want
    return max([tree_err(g_params, w_params)] + [
        rel_err(g[k], float(w[k])) for g, w in zip(g_stats, w_stats)
        for k in w])


def params0():
    return jax.tree.map(np.asarray, jppo.init_module(jax.random.key(0), 4,
                                                     2, 64))


def minibatches(n_batches=3, rows=128):
    """PPO minibatches whose old log-probabilities sit 0.4 nats from the
    policy's on average (the clip binds on some rows)."""
    rng = np.random.default_rng(5)
    params = params0()
    out = []
    for _ in range(n_batches):
        obs = rng.normal(size=(rows, 4)).astype(np.float32)
        actions = rng.integers(0, 2, size=rows).astype(np.int32)
        logits, _ = jppo._np_forward(params, obs)
        logp = np.log(jppo._softmax_rows(logits)[np.arange(rows), actions])
        out.append({
            "obs": obs, "actions": actions,
            "logp": (logp + rng.normal(0, 0.4, rows)).astype(np.float32),
            "advantages": rng.normal(size=rows).astype(np.float32),
            "returns": rng.normal(2.0, 3.0, size=rows).astype(np.float32)})
    return out


def run(group, batches):
    group.set_params(params0())
    stats = [group.update(b) for b in batches]
    return stats, group.get_params()


def jax_group(n):
    return jlg.LearnerGroup(
        init_fn=partial(jppo.init_module, obs_dim=4, n_actions=2),
        grad_fn=partial(jppo._ppo_grads, **KW), tx=optax.adam(LR),
        num_learners=n, mode="mesh", seed=0)


def port_group(n, mode="mesh"):
    return tlg.LearnerGroup(
        init_fn=partial(tppo.init_module, obs_dim=4, n_actions=2),
        loss_fn=partial(tppo.ppo_loss, **KW), tx=tppo.adam(LR),
        num_learners=n, mode=mode, seed=0, device="cpu")


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_learners_match_jax_mesh(n):
    batches = minibatches()
    want = run(jax_group(n), batches)
    got = run(port_group(n), batches)
    assert run_err(got, want) < TOL
    assert port_group(n)._impl.mesh.shape == {"dp": n}
    if n == 3:
        # control: JAX's one learner on the unpadded minibatches
        assert run_err(got, run(jax_group(1), batches)) > TOL


def test_pad_to_multiple_matches_jax():
    batch = {"x": np.arange(10), "y": np.arange(20).reshape(10, 2)}
    for k in (1, 3, 4, 10):
        got, want = tlg._pad_to_multiple(batch, k), \
            jlg._pad_to_multiple(batch, k)
        assert all(np.array_equal(got[key], want[key]) for key in batch)


def test_actor_learners_match_mesh():
    batches = minibatches()
    mesh = run(port_group(2), batches)

    def actors():
        group = port_group(2, mode="actors")
        try:
            return run(group, batches)
        finally:
            group.stop()

    got = within_limit(actors)
    assert run_err(got, mesh) < TOL
    # control: one learner on rank 0's shard alone (no all-reduce)
    alone = run(port_group(1), [{k: v[:64] for k, v in b.items()}
                                for b in batches])
    assert run_err(alone, mesh) > TOL


def test_ppo_actors_mode_matches_mesh_mode():
    cfg = tppo.PPOConfig(device="cpu", num_learners=2,
                         rollout_fragment_length=64, minibatch_size=64,
                         num_sgd_iter=2)
    mesh = tppo.PPO(cfg)
    want = mesh.train(), mesh.learner.get_params()

    def actors():
        algo = tppo.PPO(cfg.training(learner_mode="actors"))
        try:
            return algo.train(), algo.learner.get_params()
        finally:
            algo.stop()

    got = within_limit(actors)
    assert got[0]["episode_return_mean"] == want[0]["episode_return_mean"]
    assert run_err(([got[0]], got[1]), ([{k: want[0][k] for k in (
        "policy_loss", "vf_loss", "entropy")}], want[1])) < TOL


def test_impala_cell_actors_mode_matches_mesh_mode():
    """IMPALA with an lstm core: its recurrent ``init_fn`` and loss reach
    the rank processes by plain pickle, and two ranks' iterations match
    mesh mode's (control: one learner on rank 0's shard alone, the first
    trajectory, as a rank that skipped the all-reduce would step)."""
    from ray_tpu_torch.rllib import impala as timpala

    cfg = timpala.IMPALAConfig(device="cpu", num_learners=2, cell="lstm",
                               hidden=16, unroll_length=16)
    mesh = timpala.IMPALA(cfg)
    want = [mesh.train() for _ in range(2)], mesh.learner.get_params()

    def actors():
        algo = timpala.IMPALA(cfg.training(learner_mode="actors"))
        try:
            return [algo.train() for _ in range(2)], \
                algo.learner.get_params()
        finally:
            algo.stop()

    def err(got) -> float:
        return max([rel_err(got[1][k][leaf], want[1][k][leaf])
                    for k in want[1] for leaf in ("w", "b")] + [
            rel_err(g[k], w[k]) for g, w in zip(got[0], want[0])
            for k in ("policy_loss", "vf_loss", "entropy", "mean_rho")])

    got = within_limit(actors)
    assert set(got[1]) == {"enc", "cell", "pi", "vf"}
    assert got[1]["cell"]["w"].shape == (32, 64)    # lstm: 4 gate blocks
    assert err(got) < TOL
    # control: rank 0's shard alone (no all-reduce)
    alone = timpala.IMPALA(cfg.training(num_learners=0))
    half = alone.learner.loss_fn
    alone.learner.loss_fn = lambda module, batch: half(
        module, {k: v[:1] for k, v in batch.items()})
    assert err(([alone.train() for _ in range(2)],
                alone.learner.get_params())) > TOL


def _rank_plus(x):
    from ray_tpu_torch.train import session

    return session.get_context().rank + x


def _remember(value):
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    ctx.objects.setdefault("seen", []).append(value)
    return list(ctx.objects["seen"])


def _fail_on(rank):
    from ray_tpu_torch.train import session

    if session.get_context().rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return "ok"


def test_worker_group_execute_and_healthy():
    def body():
        wg = WorkerGroup(ScalingConfig(num_workers=2, use_gpu=False))
        try:
            assert wg.execute(operator.add, 2, 3) == [5, 5]
            assert wg.execute(_rank_plus, 10) == [10, 11]
            calls = wg.execute_async(_rank_plus, x=100)
            assert [c.result(timeout=60) for c in reversed(calls)] == \
                [101, 100]
            wg.execute(_remember, "a")
            assert wg.execute(_remember, "b") == [["a", "b"]] * 2
            assert wg.healthy()
            with pytest.raises(RuntimeError, match="rank 1 failed: "
                               "ValueError: rank 1 fails on purpose"):
                wg.execute(_fail_on, 1)
            assert not any(p.is_alive() for p in wg.processes)
            assert not wg.healthy()
            with pytest.raises(RuntimeError, match="rank 1 failed"):
                wg.execute(operator.add, 1, 1)
        finally:
            wg.shutdown()

    within_limit(body)


def test_a_group_running_a_loop_refuses_execute():
    wg = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=False))
    wg.processes = [object()]   # as after start(): a loop's ranks
    with pytest.raises(RuntimeError, match="runs a loop"):
        wg.execute_async(operator.add, 1, 1)
    wg.processes = []
    wg.shutdown()
