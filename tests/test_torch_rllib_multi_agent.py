"""The port's multi-agent RLlib (``ray_tpu_torch/rllib/multi_agent.py``)
against the JAX package's on the CPU.

The envs, ``PolicyMap``, ``MultiAgentReplay`` and the rollout worker are
the JAX package's numpy host code, copied; each is held to JAX's bit for
bit, with a control that must miss:

- ``MultiAgentCartPole`` and ``CoopMatchEnv``, 200 seeded joint actions
  (control: another seed);
- ``PolicyMap``'s LRU spill and readback: the same access sequence spills
  the same policies, to files of the same numpy trees (a module spills as
  its numpy tree and comes back a module on its device); control: a
  larger capacity, which spills nothing;
- ``MultiAgentReplay``'s rings and draws (control: another seed);
- the rollout worker's per-policy batches, shared and independent, with
  agents that finish at different steps (control: another seed);
- save files: JAX's read by the port, the port's read by JAX's
  ``MultiAgentPPO.restore`` (greedy actions equal; control: the policies
  swapped).

Then the refusal of a bad mapping and the learning checks of
``tests/test_multi_agent.py`` on the port. No JAX runtime starts here.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import ppo as jppo
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import multi_agent as tma
from torch_rl_threads import one_intra_op_thread  # noqa: F401 (autouse)


def jax_params(obs_dim, n_actions, seed, hidden=16) -> dict:
    return jax.tree.map(np.asarray, jppo.init_module(
        jax.random.key(seed), obs_dim, n_actions, hidden))


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            same_tree(a[k], b[k]) for k in a)
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(a, b)


def roll(env, seed, steps=200) -> list:
    rng = np.random.default_rng(seed)
    out = [env.reset()]
    obs = out[0]
    for _ in range(steps):
        acts = {a: int(rng.integers(2)) for a in sorted(obs)}
        obs, rews, dones, _ = env.step(acts)
        out += [obs, rews, dones]
        if dones["__all__"]:
            obs = env.reset()
            out.append(obs)
    return out


def same_roll(a: list, b: list) -> bool:
    def same(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and list(x) == list(y) and all(
                same(x[k], y[k]) for k in x)
        return type(x) is type(y) and np.asarray(x).dtype == \
            np.asarray(y).dtype and np.array_equal(x, y)

    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["MultiAgentCartPole", "CoopMatch-v0"])
def test_multi_agent_envs_match_jax_bit_for_bit(name):
    kw = {"num_agents": 3} if name == "MultiAgentCartPole" else {}
    want = roll(jma.make_multi_env(name, seed=3, **kw), 3)
    assert same_roll(roll(tma.make_multi_env(name, seed=3, **kw), 3), want)
    # control: another seed
    assert not same_roll(roll(tma.make_multi_env(name, seed=4, **kw), 4),
                         want)
    env = tma.make_multi_env(name, seed=0, **kw)
    assert isinstance(env, tma.MultiAgentEnv)
    assert env.obs_dim_of(env.agent_ids[0]) == jma.make_multi_env(
        name, seed=0, **kw).obs_dim_of(env.agent_ids[0])


def run_policy_map(pm_cls, states: dict, spill_dir: str, capacity=2):
    """One access sequence (JAX's test's, longer): the order of the
    policies in memory and spilled after each step, the states read, and
    the spill files' contents."""
    pm = pm_cls(capacity=capacity, spill_dir=spill_dir)
    trace, reads = [], []
    for step in ("p0", "p1", "p2", "get p0", "p3", "get p1", "get p2"):
        if step.startswith("get"):
            reads.append(pm[step.split()[1]])
        else:
            pm[step] = states[step]
        trace.append((list(pm._mem), sorted(pm._spilled)))
    files = {}
    names = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
    for name in sorted(names):
        with open(os.path.join(spill_dir, name), "rb") as f:
            files[name] = pickle.load(f)
    return trace, reads, files, pm


def test_policy_map_spills_and_reads_back_as_jax(tmp_path):
    trees = {f"p{i}": jax_params(2, 2, i) for i in range(4)}
    modules = {k: convert.policy_value_from_numpy(v, device="cpu")
               for k, v in trees.items()}
    want = run_policy_map(jma.PolicyMap, trees, str(tmp_path / "jax"))
    got = run_policy_map(tma.PolicyMap, modules, str(tmp_path / "port"))
    assert got[0] == want[0]
    assert want[0][-1][1] and set(got[2]) == set(want[2])
    assert all(same_tree(got[2][k], want[2][k]) for k in want[2])
    # a spilled module comes back a module on its device, its numbers kept
    for module, tree in zip(got[1], want[1]):
        assert isinstance(module, torch.nn.Module)
        assert next(module.parameters()).device == torch.device("cpu")
        assert same_tree(module.numpy_tree(), tree)
    pm = got[3]
    assert sorted(pm.keys()) == ["p0", "p1", "p2", "p3"] and len(pm) == 4
    assert "p3" in pm and "p9" not in pm
    with pytest.raises(KeyError):
        pm["p9"]
    # numpy trees pass through unchanged, as JAX's do
    again = run_policy_map(tma.PolicyMap, trees, str(tmp_path / "np"))
    assert again[0] == want[0] and all(
        same_tree(a, b) for a, b in zip(again[1], want[1]))
    # control: room for every policy spills nothing
    roomy = run_policy_map(tma.PolicyMap, modules, str(tmp_path / "roomy"),
                           capacity=4)
    assert roomy[0] != want[0] and roomy[2] == {}


def test_multi_agent_replay_matches_jax_bit_for_bit():
    def run(mod, seed):
        rep = mod.MultiAgentReplay(capacity_per_policy=64, seed=seed)
        rng = np.random.default_rng(5)
        draws = []
        for n, pid in ((10, "p0"), (5, "p1"), (70, "p0"), (30, "p1")):
            rep.add(pid, {"obs": rng.standard_normal((n, 3)).astype(
                np.float32), "r": rng.standard_normal(n),
                "a": rng.integers(0, 4, n).astype(np.int32)})
            draws += [rep.sample(p, 8) for p in rep.policy_ids()]
        return draws, {p: rep.size(p) for p in rep.policy_ids()}, \
            rep._buffers

    want = run(jma, 0)
    got = run(tma, 0)
    assert got[1] == want[1] == {"p0": 64, "p1": 35}
    assert all(same_tree(g, w) for g, w in zip(got[0], want[0]))
    assert same_tree(got[2], want[2])
    # control: another seed draws other rows
    assert not all(same_tree(g, w) for g, w in zip(run(tma, 1)[0], want[0]))
    with pytest.raises(ValueError, match="no experience"):
        tma.MultiAgentReplay().sample("p0", 4)


def shared(agent_id):
    return "shared"


def own(agent_id):
    return f"p_{agent_id}"


@pytest.mark.parametrize("env,mapping", [
    ("CoopMatch-v0", shared), ("CoopMatch-v0", own),
    ("MultiAgentCartPole", own)])
def test_rollout_worker_batches_match_jax_bit_for_bit(env, mapping):
    kw = {"num_agents": 2} if env == "MultiAgentCartPole" else {}
    probe = tma.make_multi_env(env, seed=0, **kw)
    obs_dim = probe.obs_dim_of(probe.agent_ids[0])
    policies = {mapping(a): jax_params(obs_dim, 2, i)
                for i, a in enumerate(probe.agent_ids)}
    jw = jma._MultiAgentRolloutWorker(env, mapping, 1000, kw)
    tw = tma._MultiAgentRolloutWorker(env, mapping, 1000, kw)
    for _ in range(2):
        got = tw.sample(policies, 96, 0.99, 0.95)
        want = jw.sample(policies, 96, 0.99, 0.95)
        assert got["episode_returns"] == want["episode_returns"]
        assert list(got["batches"]) == list(want["batches"])
        assert same_tree(got["batches"], want["batches"])
    assert set(got["batches"]) == set(policies)
    # control: another seed
    other = tma._MultiAgentRolloutWorker(env, mapping, 1001, kw).sample(
        policies, 96, 0.99, 0.95)
    assert not same_tree(other["batches"], want["batches"])


def build(policies=("p_a0", "p_a1"), mapping=own, **kw):
    return (tma.MultiAgentPPOConfig(device="cpu")
            .environment("CoopMatch-v0")
            .multi_agent(policies=list(policies), policy_mapping_fn=mapping)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(hidden=16, **kw).build())


def test_save_files_read_by_both_packages(tmp_path):
    # JAX's save format: a pickle of {policy id: numpy tree}
    path = str(tmp_path / "jax.pkl")
    state = {pid: jax_params(2, 2, 10 + i)
             for i, pid in enumerate(("p_a0", "p_a1"))}
    with open(path, "wb") as f:
        pickle.dump(state, f)
    algo = build()
    algo.restore(path)
    assert same_tree(algo._policies_np(), state)
    algo.train()
    port_path = str(tmp_path / "port.pkl")
    algo.save(port_path)

    def jax_restored(saved: str) -> tuple:
        # JAX's restore and compute_actions need no runtime: a shell
        # algorithm holding JAX's policy map and the mapping
        shell = object.__new__(jma.MultiAgentPPO)
        shell.policies, shell.mapping = jma.PolicyMap(), own
        shell.restore(saved)
        return shell._policies_np(), [shell.compute_actions(o) for o in obs]

    rng = np.random.default_rng(0)
    obs = [{a: rng.choice([-1.0, 1.0], size=2).astype(np.float32)
            for a in ("a0", "a1")} for _ in range(16)]
    policies, actions = jax_restored(port_path)
    assert same_tree(policies, algo._policies_np())
    assert actions == [algo.compute_actions(o) for o in obs]
    # control: the two policies swapped in the file
    with open(port_path, "rb") as f:
        saved = pickle.load(f)
    swapped = str(tmp_path / "swapped.pkl")
    with open(swapped, "wb") as f:
        pickle.dump({"p_a0": saved["p_a1"], "p_a1": saved["p_a0"]}, f)
    assert not same_tree(jax_restored(swapped)[0], algo._policies_np())


def test_bad_mapping_is_refused():
    with pytest.raises(ValueError, match="not in"):
        build(policies=["only"], mapping=lambda aid: aid)
    with pytest.raises(ValueError, match="no mapped agents"):
        build(policies=["p_a0", "p_a1", "unused"])


def best_return(algo, target, iters) -> float:
    best = -np.inf
    for _ in range(iters):
        best = max(best, algo.train()["episode_return_mean"])
        if best >= target:
            break
    return best


def test_ma_ppo_learns_shared_policy():
    algo = (tma.MultiAgentPPOConfig(device="cpu")
            .environment("CoopMatch-v0")
            .multi_agent(policies=["shared"],
                         policy_mapping_fn=lambda aid: "shared")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(lr=3e-3, minibatch_size=256, hidden=32, seed=0)
            .build())
    # random play matches with prob 0.25 -> return 0.25; solved = 1.0
    best = best_return(algo, 0.9, 30)
    assert best >= 0.9, f"shared MA-PPO failed to learn: {best}"


def test_ma_ppo_learns_independent_policies():
    algo = (tma.MultiAgentPPOConfig(device="cpu")
            .environment("CoopMatch-v0")
            .multi_agent(policies=["p_a0", "p_a1"],
                         policy_mapping_fn=lambda aid: f"p_{aid}")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=256)
            .training(lr=3e-3, minibatch_size=256, hidden=32, seed=1)
            .build())
    best = best_return(algo, 0.9, 40)
    assert best >= 0.9, f"independent MA-PPO failed to learn: {best}"
    result = algo.train()
    assert result["policy_ids"] == ["p_a0", "p_a1"]
