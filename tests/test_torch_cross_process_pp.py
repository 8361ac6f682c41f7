"""pp and ep across rank processes on the CPU, ElasticTrainer's reform to
a new world, and checkpoints that restore across layouts: the port
against the JAX package on the same global mesh of JAX's 8 CPU devices.

Each world is spawned once for all its cases (``DataParallelTrainer``
with ``ScalingConfig(num_workers=n, use_gpu=False)``, the loop
``torch_harness_loops.spanned_loop``), joined within 120 s and its ranks
killed on expiry. In float32 at tiny widths, from JAX's initial weights
(``convert.params_from_numpy``):

- **pp**: ``llama_tiny`` under ``pp_fsdp`` with 4 microbatches, 2 steps,
  on {pp 2} at world 2, {pp 2, fsdp 2} at world 4 and {pp 4} at world 4
  (four layers), each process running its own stage of the 1F1B: every
  chunk of each process's final parameters and Adam moments within 2e-4
  of ``JaxTrainer``'s ``addressable_shards`` at that place, the losses
  and gradient norms within 1e-5 relative. Controls: the gradients sent
  to stage s+1 in place of s-1 ({pp 4}: on two stages the two
  directions are one), and the io gradients not summed over the stages.
  The generic ``pipeline_value_and_grad`` on the pipeline tests' toy over
  {pp 4}, with and without ``embed_fn``, against JAX's.
- **ep**: ``mixtral_tiny``'s ``spmd.placed_forward`` under moe on {ep 2}
  at world 2 and {fsdp 2, ep 2} at world 4, at a capacity factor that
  drops tokens: each process's logit rows within 2e-4 of JAX's jitted
  forward on its placed tree, the aux loss within 1e-5 relative, each
  process running its own experts. Control: each process routing its
  own tokens with a capacity of its own (world 4).
- **checkpoints and elastic**: ``ElasticTrainer(process_group=)`` on
  {fsdp 2, tp 2} at world 4 takes 2 steps and saves (each process its
  chunks); two survivors join a new group and reform onto {fsdp 2}. The
  checkpoint restored whole here and at world 2 equals the saved chunks
  bit for bit and JAX's state within 2e-4; the step after the reform
  matches JAX's ``ElasticTrainer.reform`` onto 2 devices; a missing
  per-process file raises. In-process checks of the restore's assembly
  across layouts, and of the 1F1B's posts, run without spawning.
"""

import dataclasses
import math
import multiprocessing
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_harness_loops as loops
from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmixtral
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.sharding import PRESETS as JAX_PRESETS
from ray_tpu.parallel.sharding import shard_tree as jax_shard_tree
from ray_tpu.train.elastic import ElasticTrainer as JaxElasticTrainer
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmixtral
from ray_tpu_torch.parallel import pipeline
from ray_tpu_torch.parallel.mesh import (Mesh, ProcessLayout, create_mesh,
                                         split_axes)
from ray_tpu_torch.parallel.sharding import NamedSharding, P, device_put
from ray_tpu_torch.train import data_parallel_trainer as dpt
from ray_tpu_torch.train.checkpoint import CheckpointManager, _range_key

LIMIT_S = 120.0
VOCAB = 160
STEPS = 2
LR = 1e-3
# mixtral_tiny routes 64 tokens a layer at world 4's batch: a capacity of
# 0.5 · 64 · 2 / 4 = 16 slots an expert drops some of the 128 choices
CAPACITY_FACTOR = 0.5
ELASTIC_STEPS = 2
SURVIVORS = 2


def _llama(**over):
    return tuple(dataclasses.replace(mod.llama_tiny(VOCAB), dtype="float32",
                                     **over) for mod in (jllama, tllama))


def _mixtral():
    return tuple(dataclasses.replace(mod.mixtral_tiny(VOCAB),
                                     dtype="float32",
                                     capacity_factor=CAPACITY_FACTOR)
                 for mod in (jmixtral, tmixtral))


def _tokens(b, s, seed):
    tokens = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    tokens[-1, -5:] = -1
    return tokens.astype(np.int64)


def _jax_mesh(axes):
    n = math.prod(axes.values())
    return jax_create_mesh(axes, devices=jax.devices()[:n])


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _final(jstate) -> dict:
    adam = jstate.opt_state[1][0]
    return {f"{tree}.{k}": v for tree, node in (
        ("params", jstate.params), ("mu", adam.mu), ("nu", adam.nu))
        for k, v in _named(node)}


# --- the cases ---------------------------------------------------------------

# name -> (mesh, world, config overrides, batch rows)
PP_CASES = {
    "pp2_world2": ({"pp": 2}, 2, {}, 8),
    "pp2_fsdp2_world4": ({"pp": 2, "fsdp": 2}, 4, {}, 8),
    "pp4_world4": ({"pp": 4}, 4, {"n_layers": 4}, 4),
}
PP_CONTROLS = {
    "control_backward_to_next_stage": ("pp4_world4",
                                       "backward_to_next_stage"),
    "control_io_sum_skipped": ("pp2_fsdp2_world4", "io_sum_skipped"),
}
# name -> (mesh, world)
EP_CASES = {
    "ep2_world2": ({"ep": 2}, 2),
    "fsdp2_ep2_world4": ({"fsdp": 2, "ep": 2}, 4),
}
EP_CONTROLS = {"control_local_routing": ("fsdp2_ep2_world4",
                                         "local_routing")}


def _pp_reference(name):
    axes, world, over, b = PP_CASES[name]
    jcfg, tcfg = _llama(**over)
    train = dict(mesh_axes=axes, strategy="pp_fsdp", learning_rate=LR,
                 warmup_steps=1, total_steps=50, n_microbatches=4)
    jmesh = _jax_mesh(axes)
    jt = JaxTrainer(jcfg, JaxTrainConfig(**train), mesh=jmesh)
    jstate = jt.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = [_tokens(b, 32, seed) for seed in range(STEPS)]
    losses, norms = [], []
    for batch in batches:
        jstate, m = jt.train_step(jstate, jnp.asarray(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    case = {"model_config": tcfg, "train": train, "params": params,
            "batches": batches}
    return {"case": case, "jmesh": jmesh, "losses": losses, "norms": norms,
            "final": _final(jstate), "world": world}


def _ep_reference(name):
    axes, world = EP_CASES[name]
    jcfg, tcfg = _mixtral()
    jmesh = _jax_mesh(axes)
    params = jmixtral.init_params(jcfg, jax.random.key(0))
    placed = jax_shard_tree(params, jmixtral.param_logical_axes(jcfg),
                            jmesh, JAX_PRESETS["moe"])
    tokens = np.random.default_rng(2).integers(0, VOCAB, (4, 16))
    logits, aux = jax.jit(lambda p, t: jmixtral.forward(
        jcfg, p, t, return_aux_loss=True))(placed, jnp.asarray(tokens))
    case = {"model_config": tcfg, "axes": axes, "tokens": tokens,
            "params": jax.tree.map(np.asarray, params)}
    return {"case": case, "logits": np.asarray(logits), "aux": float(aux),
            "world": world}


def _toy():
    """``tests/test_torch_pipeline.py``'s toy at 4 stages: 6 microbatches
    of [2, 5], width 8, a tied 11-token vocabulary."""
    rng = np.random.default_rng(0)
    m, mb, seq, d, v = 6, 2, 5, 8, 11
    return dict(
        w=rng.standard_normal((4, d, d)).astype(np.float32) * 0.5,
        emb=rng.standard_normal((v, d)).astype(np.float32),
        tok=rng.integers(0, v, (m, mb, seq)).astype(np.int32),
        tgt=rng.integers(0, v, (m, mb, seq)).astype(np.int32),
        msk=(rng.random((m, mb, seq)) < 0.8).astype(np.float32),
        x=rng.standard_normal((m, mb, seq, d)).astype(np.float32))


def _pipeline_reference(toy):
    """JAX's 1F1B on the toy over {pp 4}, with and without embed_fn."""
    def stage(sp, x):
        return jnp.tanh(x @ sp["w"])

    def head(io, y, t, m):
        logits = y @ io["emb"].T
        lse = jax.nn.logsumexp(logits, -1)
        tl = jnp.take_along_axis(logits, t[..., None], -1)[..., 0]
        return jnp.sum((lse - tl) * m), jnp.sum(m)

    out = {}
    for embed in (False, True):
        (loss, weight), (d_sp, d_io, d_x) = jpipe.pipeline_value_and_grad(
            stage, head, {"w": jnp.asarray(toy["w"])},
            {"emb": jnp.asarray(toy["emb"])},
            jnp.asarray(toy["tok"] if embed else toy["x"]),
            jnp.asarray(toy["tgt"]), jnp.asarray(toy["msk"]),
            mesh=_jax_mesh({"pp": 4}),
            embed_fn=(lambda io, t: io["emb"][t]) if embed else None)
        out[embed] = {"loss": float(loss), "weight": float(weight),
                      "d_w": np.asarray(d_sp["w"]),
                      "d_emb": np.asarray(d_io["emb"]),
                      "d_x": None if d_x is None else np.asarray(d_x)}
    return out


def _elastic_reference(tmp):
    """JAX's ElasticTrainer on 4 devices ({fsdp 2, tp 2}) for
    ELASTIC_STEPS steps with a checkpoint, reformed onto 2 ({fsdp 2}), one
    more step: its initial weights, the state at the save and at the end,
    the losses and norms after the reform."""
    jcfg, tcfg = _llama()
    train = dict(strategy="fsdp_tp", learning_rate=LR, warmup_steps=1,
                 total_steps=50)
    jet = JaxElasticTrainer(jcfg, JaxTrainConfig(**train),
                            checkpoint_dir=str(tmp / "jax"),
                            mesh_axes_fn=loops.elastic_axes,
                            devices=jax.devices()[:4],
                            checkpoint_every=ELASTIC_STEPS)
    jstate = jet.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = [_tokens(4, 32, 10 + i) for i in range(ELASTIC_STEPS + 1)]
    jstate = jet.fit(jstate, iter(batches[:ELASTIC_STEPS]),
                     steps=ELASTIC_STEPS)
    saved = {k: np.asarray(v) for k, v in _final(jstate).items()}
    jstate = jet.reform(devices=jax.devices()[:SURVIVORS])
    metrics = []
    jstate = jet.fit(jstate, iter(batches[ELASTIC_STEPS:]), steps=1,
                     on_metrics=metrics.append)
    job = {"model_config": tcfg, "train": train, "params": params,
           "batches": batches, "steps": ELASTIC_STEPS,
           "survivors": SURVIVORS,
           "checkpoint_dir": str(tmp / "torch_ckpt")}
    out = {"job": job, "saved": saved, "final": _final(jstate),
           "jmesh": jet.trainer.mesh,
           "losses": [m["loss"] for m in metrics],
           "norms": [m["grad_norm"] for m in metrics]}
    jet.close()
    return out


def _fit(trainer):
    """``trainer.fit()`` within LIMIT_S: on expiry every child process is
    killed and the test fails. Afterwards no child process is left."""
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        pytest.fail(f"fit() did not finish within {LIMIT_S} s")
    assert multiprocessing.active_children() == []
    if "error" in box:
        raise box["error"]
    return box["result"]


def _load(out, name, world):
    return [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX reference and its ranks' results: each world
    spawned once for all its cases, world 4's elastic job last."""
    tmp = tmp_path_factory.mktemp("spanned")
    pp = {n: _pp_reference(n) for n in PP_CASES}
    ep = {n: _ep_reference(n) for n in EP_CASES}
    elastic = _elastic_reference(tmp)
    toy = _toy()
    elastic["pipeline"] = _pipeline_reference(toy)
    got = {}
    for world in (2, 4):
        out = tmp / f"world{world}"
        out.mkdir()
        train = {n: r["case"] for n, r in pp.items() if r["world"] == world}
        train.update({n: {**pp[base]["case"], "control": control}
                      for n, (base, control) in PP_CONTROLS.items()
                      if pp[base]["world"] == world})
        forward = {n: r["case"] for n, r in ep.items() if r["world"] == world}
        forward.update({n: {**ep[base]["case"], "control": control}
                        for n, (base, control) in EP_CONTROLS.items()
                        if ep[base]["world"] == world})
        config = {"train": train, "forward": forward, "out": str(out)}
        if world == 4:
            config.update(elastic=elastic["job"], pipeline=toy)
        result = _fit(dpt.DataParallelTrainer(
            loops.spanned_loop,
            scaling_config=ScalingConfig(num_workers=world, use_gpu=False),
            train_loop_config=config,
            run_config=RunConfig(storage_path=str(tmp / f"runs{world}"))))
        assert result.error is None, result.error
        for name in list(train) + list(forward):
            got[name] = _load(out, name, world)
        if world == 4:
            got["pipeline"] = {embed: _load(out, f"pipeline_{embed}", world)
                               for embed in (False, True)}
            got["elastic"] = {
                "saved": _load(out, "saved", world),
                **{stage: _load(out, stage, SURVIVORS)
                   for stage in ("restored", "after")}}
    return pp, ep, elastic, got


# --- pp ----------------------------------------------------------------------


def _chunk_err(final, jmesh, ranks) -> float:
    """The worst error of the ranks' chunks (``<leaf>@<global place>``)
    against JAX's shards at those places."""
    flat = list(jmesh.devices.ravel())
    err = 0.0
    for rank in ranks:
        for key, got in rank.items():
            if "@" not in key:
                continue
            leaf, place = key.split("@")
            want = next(np.asarray(sh.data) for sh in
                        final[leaf].addressable_shards
                        if sh.device == flat[int(place)])
            assert got.shape == want.shape, key
            err = max(err, float(np.abs(got - want).max()))
    return err


def _pp_errors(ref, ranks) -> dict:
    rel = max(float(np.abs(np.asarray(r[k]) / np.asarray(w) - 1).max())
              for r in ranks for k, w in (("losses", ref["losses"]),
                                          ("grad_norms", ref["norms"])))
    return {"chunk": _chunk_err(ref["final"], ref["jmesh"], ranks),
            "rel": rel}


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_stage_processes_match_jax_trainer(runs, name):
    """Every chunk of each stage process's final parameters and moments
    (its stage's layers, the io parameters' replica) within 2e-4 of
    JAX's shards at its places; losses and norms within 1e-5
    relative."""
    pp, _, _, got = runs
    errs = _pp_errors(pp[name], got[name])
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


@pytest.mark.parametrize("name", list(PP_CONTROLS))
def test_pp_controls_break_the_bound(runs, name):
    pp, _, _, got = runs
    errs = _pp_errors(pp[PP_CONTROLS[name][0]], got[name])
    assert errs["chunk"] > 2e-4 or errs["rel"] > 1e-5, errs


@pytest.mark.parametrize("embed", [False, True])
def test_1f1b_across_processes_matches_jax(runs, embed):
    """``pipeline_value_and_grad`` on the pipeline tests' toy over {pp 4}
    at world 4, each process its own stage (with and without
    ``embed_fn``): every process's loss and weight sums, io gradient (the
    tied embedding's, from the head and the lookup: summed over the
    stages) and input gradient equal JAX's, and its stage's gradient
    JAX's at its stage."""
    _, _, elastic, got = runs
    want = elastic["pipeline"][embed]
    for rank, r in enumerate(got["pipeline"][embed]):
        np.testing.assert_allclose(float(r["loss"]), want["loss"],
                                   rtol=1e-5)
        assert float(r["weight"]) == want["weight"]
        np.testing.assert_allclose(r["d_w"], want["d_w"][rank], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["d_emb"], want["d_emb"], rtol=1e-4,
                                   atol=1e-5)
        if embed:
            assert "d_x" not in r
        else:
            np.testing.assert_allclose(r["d_x"], want["d_x"], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("stages,micro", [(2, 4), (3, 4), (4, 4), (4, 6)])
def test_1f1b_posts_are_the_receivers_slots(stages, micro):
    """Each tick's moves, derived from the schedule's formulas: a stage
    sends its output on exactly when the next stage's forward slot takes
    it at the next tick, and its input gradient back exactly when the
    previous stage's backward slot takes it; the last stage sends no
    activation and the first no gradient, and nothing is sent after the
    schedule's T = M + 2(S-1) ticks."""
    ticks = micro + 2 * (stages - 1)
    for t in range(ticks + 2):
        fwd, bwd = pipeline._tick_posts(t, stages, micro)
        want_f = [(s - 1, s) for s in range(1, stages)
                  if 0 <= (t + 1) - s < micro]
        want_b = [(s + 1, s) for s in range(stages - 1)
                  if 0 <= (t + 1) - 2 * (stages - 1) + s < micro]
        assert sorted(fwd) == want_f, (t, fwd)
        assert sorted(bwd) == sorted(want_b), (t, bwd)
        if t >= ticks - 1:
            assert not fwd and not bwd


# --- ep ----------------------------------------------------------------------


def _rows(world, axes, rank, b):
    """The batch rows of ``rank``: its block along the data axes that span
    processes (fsdp here)."""
    if "fsdp" not in axes:
        return slice(0, b)
    layout = split_axes(axes, world)[1]
    names = list(layout)
    index = dict(zip(names, np.unravel_index(rank, [layout[a]
                                                    for a in names])))
    per = b // axes["fsdp"]
    return slice(int(index["fsdp"]) * per, (int(index["fsdp"]) + 1) * per)


def _ep_errors(ref, ranks) -> dict:
    axes = ref["case"]["axes"]
    b = ref["logits"].shape[0]
    logit = max(float(np.abs(r["logits"] - ref["logits"][
        _rows(ref["world"], axes, i, b)]).max()) for i, r in enumerate(ranks))
    aux = max(abs(float(r["aux"]) / ref["aux"] - 1) for r in ranks)
    return {"logits": logit, "aux_rel": aux}


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_processes_rows_match_jax_forward(runs, name):
    """Each process's rows of the logits within 2e-4 of JAX's forward on
    its placed tree, and the global aux loss within 1e-5 relative."""
    _, ep, _, got = runs
    errs = _ep_errors(ep[name], got[name])
    assert errs["logits"] <= 2e-4 and errs["aux_rel"] <= 1e-5, errs


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_routing_is_global_and_drops_tokens(runs, name):
    """Every process routes the global batch's 64 tokens once a layer
    (the logits gathered over the data processes), with a capacity that
    drops some of their top-2 choices."""
    _, ep, _, got = runs
    cfg = ep[name]["case"]["model_config"]
    for r in got[name]:
        kept, assigned = r["routed"].T
        assert list(assigned) == [64 * cfg.top_k] * cfg.n_layers
        assert (kept < assigned).all(), r["routed"]


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_processes_run_their_own_experts(runs, name):
    """Each process's ``_expert_ffn`` sees its ep index's 2 of the 4
    experts (at the global capacity), their whole mlp and model width."""
    _, ep, _, got = runs
    cfg = ep[name]["case"]["model_config"]
    capacity = int(CAPACITY_FACTOR * 64 * cfg.top_k / cfg.n_experts)
    for r in got[name]:
        assert r["experts"].tolist() == [
            [2, capacity, cfg.d_model, 2, cfg.d_model, cfg.d_ff]
        ] * cfg.n_layers


def test_ep_local_routing_control_breaks_the_bound(runs):
    """Control: each process routes its own tokens with a capacity of its
    own token count. World 4 cuts the batch over fsdp, so its routing
    leaves JAX's global one."""
    _, ep, _, got = runs
    base = EP_CONTROLS["control_local_routing"][0]
    errs = _ep_errors(ep[base], got["control_local_routing"])
    assert errs["logits"] > 2e-4 or errs["aux_rel"] > 1e-5, errs


# --- checkpoints across layouts and the elastic reform ----------------------


def _ranged(rank) -> dict:
    return {k: v for k, v in rank.items() if "|" in k}


def _slice(key):
    return tuple(slice(*map(int, part.split(":")))
                 for part in key.split("|")[1].split(","))


@pytest.fixture(scope="module")
def restored_whole(runs):
    """The elastic run's checkpoint restored whole in this process."""
    _, _, elastic, _ = runs
    ckpt = elastic["job"]["checkpoint_dir"]
    assert sorted(os.listdir(ckpt)) == [f"{ELASTIC_STEPS}.proc{r}of4.pt"
                                        for r in range(4)]
    state = CheckpointManager(ckpt).restore(device="cpu")
    return {f"{t}.{k}": v.numpy() for t, tree in (
        ("params", state.params), ("mu", state.opt_state["mu"]),
        ("nu", state.opt_state["nu"])) for k, v in _named(tree)}


def test_checkpoint_restores_whole_bit_for_bit(runs, restored_whole):
    """Saved at world 4 on {fsdp 2, tp 2} (each process its chunks) and
    restored whole in one process: every saved chunk equals its range of
    the restored leaf bit for bit, and the chunks cover every leaf."""
    _, _, _, got = runs
    covered = {k: np.zeros(v.shape, bool) for k, v in restored_whole.items()}
    for rank in got["elastic"]["saved"]:
        for key, chunk in _ranged(rank).items():
            leaf, idx = key.split("|")[0], _slice(key)
            np.testing.assert_array_equal(restored_whole[leaf][idx], chunk,
                                          err_msg=key)
            covered[leaf][idx] = True
    assert all(c.all() for c in covered.values())


def test_checkpoint_restores_at_world2_bit_for_bit(runs, restored_whole):
    """The survivors' restore onto {fsdp 2} at world 2: each process's
    chunks (whole over the former tp) equal their ranges of the saved
    state bit for bit, at the saved step and count."""
    _, _, _, got = runs
    for rank in got["elastic"]["restored"]:
        assert int(rank["step"]) == ELASTIC_STEPS == int(rank["count"])
        keys = _ranged(rank)
        assert keys
        for key, chunk in keys.items():
            np.testing.assert_array_equal(
                restored_whole[key.split("|")[0]][_slice(key)], chunk,
                err_msg=key)


@pytest.mark.parametrize("where", ["whole", "world2"])
def test_checkpoint_restores_within_jax(runs, restored_whole, where):
    """Both restores within 2e-4 of JAX's state at the save (whole) and
    after JAX's reform (world 2, each process at its places)."""
    _, _, elastic, got = runs
    if where == "whole":
        err = max(float(np.abs(v - elastic["saved"][k]).max())
                  for k, v in restored_whole.items())
    else:
        err = max(float(np.abs(chunk - elastic["saved"][key.split("|")[0]][
            _slice(key)]).max())
            for rank in got["elastic"]["restored"]
            for key, chunk in _ranged(rank).items())
    assert err <= 2e-4, err


def test_missing_per_process_file_raises(runs, tmp_path):
    """A per-process save lacking one process's file is not listed, and
    restoring its step raises naming the missing file: nothing is
    filled in."""
    _, _, elastic, _ = runs
    ckpt = tmp_path / "ckpt"
    shutil.copytree(elastic["job"]["checkpoint_dir"], ckpt)
    (ckpt / f"{ELASTIC_STEPS}.proc2of4.pt").unlink()
    mgr = CheckpointManager(str(ckpt))
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="proc2of4"):
        mgr.restore(ELASTIC_STEPS, device="cpu")


def test_elastic_step_after_the_reform_matches_jax(runs):
    """The survivors' step after the reform, on {fsdp 2} at world 2,
    against JAX's after ``ElasticTrainer.reform`` onto 2 devices: every
    chunk of the parameters and moments within 2e-4 at its place, the
    loss and norm within 1e-5 relative."""
    _, _, elastic, got = runs
    after = got["elastic"]["after"]
    errs = _pp_errors({"final": elastic["final"], "jmesh": elastic["jmesh"],
                       "losses": elastic["losses"],
                       "norms": elastic["norms"]}, after)
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


def test_elastic_reform_event_and_restart_bucket(runs):
    """The reform records the restored step, the places before (4) and
    after (2), and its seconds in the run's restart bucket."""
    _, _, _, got = runs
    for rank in got["elastic"]["after"]:
        step, old, new, seconds = rank["event"]
        assert (step, old, new) == (ELASTIC_STEPS, 4, SURVIVORS)
        assert float(rank["restart_s"]) == seconds > 0
        assert str(rank["mesh"]) == str({"fsdp": 2})
        assert int(rank["step"]) == ELASTIC_STEPS + 1


# --- the restore's assembly, in this process --------------------------------


def _rank_mesh(axes, world, rank) -> Mesh:
    """Rank ``rank``'s part of the global mesh ``axes`` dealt to ``world``
    processes, every place on the CPU (no group: only indices are
    read)."""
    local, procs = split_axes(axes, world)
    names = list(procs)
    index = dict(zip(names, map(int, np.unravel_index(
        rank, [procs[a] for a in names])))) if names else {}
    mesh = create_mesh(local, devices=["cpu"] * math.prod(local.values()))
    return Mesh(mesh.devices, mesh.axis_names,
                ProcessLayout(rank, world, local, procs, index, {}))


LEAF = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12) / 7
SAVED = ({"fsdp": 2, "tp": 2}, 4, P("fsdp", "tp"))


def _save_per_process(directory, step=3, axes=SAVED[0], world=SAVED[1],
                      spec=SAVED[2]):
    for r in range(world):
        st = device_put(LEAF, NamedSharding(_rank_mesh(axes, world, r), spec))
        CheckpointManager(str(directory), async_save=False).save(
            step, {"w": st, "b": LEAF[0].clone(), "n": 5})


@pytest.mark.parametrize("axes,world,spec", [
    ({"fsdp": 2}, 2, P("fsdp")),
    ({"tp": 4}, 4, P(None, "tp")),
    ({"dp": 2, "fsdp": 4}, 2, P("fsdp", None)),
    ({"fsdp": 2, "tp": 2}, 1, P("tp", "fsdp")),
])
def test_restore_assembles_any_layout(tmp_path, axes, world, spec):
    """A leaf saved by four processes on {fsdp 2, tp 2} restores into the
    places of other meshes and worlds (each rank's places: its ranges of
    the leaf, bit for bit; replicas on one device one tensor), and
    whole, in one process, as the leaf itself."""
    _save_per_process(tmp_path)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    whole = mgr.restore(device="cpu")
    assert torch.equal(whole["w"], LEAF) and whole["n"] == 5
    for r in range(world):
        mesh = _rank_mesh(axes, world, r) if world > 1 else \
            create_mesh(axes, devices=["cpu"] * math.prod(axes.values()))
        sh = NamedSharding(mesh, spec)
        got = mgr.restore(shardings={"w": sh, "b": NamedSharding(mesh, P()),
                                     "n": None})["w"]
        for idx, chunk in zip(sh.indices(LEAF.shape), got.chunks):
            assert torch.equal(chunk, LEAF[idx]), (r, _range_key(idx))
        assert len({id(c) for c in got.chunks}) == len(
            {_range_key(i) for i in sh.indices(LEAF.shape)})


@pytest.mark.parametrize("fault", ["missing_chunk", "gap", "overlap"])
def test_chunks_that_do_not_tile_the_leaf_raise(tmp_path, fault):
    """A chunk missing from the files, a gap, or ranges that overlap raise
    an error naming the leaf; nothing is padded."""
    _save_per_process(tmp_path)
    path = tmp_path / "3.proc1of4.pt"
    payload = torch.load(path, weights_only=True)
    chunks = payload["tree"]["w"]["chunks"]
    (key, chunk), = chunks.items()
    if fault == "missing_chunk":
        # rank 1's chunk (rows 0:4, columns 6:12) now claims rank 0's
        # range, so no file holds its own
        chunks.clear()
        chunks["0:4,0:6"] = chunk
    elif fault == "gap":
        del chunks[key]
        chunks["0:4,6:11"] = chunk[:, :5]
    else:
        del chunks[key]
        chunks["0:4,5:12"] = torch.cat([chunk[:, :1], chunk], dim=1)
    torch.save(payload, path)
    with pytest.raises(ValueError, match=r"state\.w"):
        CheckpointManager(str(tmp_path)).restore(3, device="cpu")


def test_all_steps_list_whole_and_complete_per_process_saves(tmp_path):
    """``all_steps`` lists steps saved whole and per-process saves with
    every process's file; a process's own listing (retention) its files
    alone."""
    _save_per_process(tmp_path, step=3)
    _save_per_process(tmp_path, step=5)
    CheckpointManager(str(tmp_path), async_save=False).save(4, {"w": LEAF})
    (tmp_path / "5.proc3of4.pt").unlink()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert mgr.all_steps((3, 4)) == [3]
    assert mgr.all_steps((0, 4)) == [3, 5]
    assert torch.equal(mgr.restore(device="cpu")["w"], LEAF)


@pytest.mark.parametrize("axes,world,local", [
    ({"pp": 2}, 2, {"pp": 1}),
    ({"pp": 2, "fsdp": 2}, 4, {"pp": 1, "fsdp": 1}),
    ({"fsdp": 2, "ep": 2, "tp": 2}, 4, {"fsdp": 1, "ep": 1, "tp": 2}),
])
def test_pp_and_ep_span_processes(axes, world, local):
    """``split_axes`` deals pp and ep to processes, one index a process,
    as it deals fsdp."""
    assert split_axes(axes, world)[0] == local
