"""The port's pipeline (``parallel/pipeline.py``) against ray_tpu's, on the
CPU.

The port's schedules are host loops over ticks and stages (inactive
slots skipped); JAX's are lockstep scans over its CPU devices. On a toy
stage whose embedding and head share one weight (tied), both must give
the same outputs, losses and gradients (float32: summation order only,
1e-5 relative). Then Llama: the GPipe forward against JAX's and the
plain forward, and the ``pp_fsdp`` trainer against JaxTrainer on a
{pp 2, dp 2, fsdp 2} mesh with 4 microbatches (JAX's own test is
``tests/test_pipeline.py:117``); with a backward slot that reads the
wrong stash slot, the gradients must part from the schedule's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.parallel.sharding import place_tree
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

S, M, MB, SEQ, D, V = 4, 6, 2, 5, 8, 11
VOCAB = 128


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    return dict(
        w=rng.standard_normal((S, D, D)).astype(np.float32) * 0.5,
        emb=rng.standard_normal((V, D)).astype(np.float32),
        tok=rng.integers(0, V, (M, MB, SEQ)).astype(np.int32),
        tgt=rng.integers(0, V, (M, MB, SEQ)).astype(np.int32),
        msk=(rng.random((M, MB, SEQ)) < 0.8).astype(np.float32),
        x=rng.standard_normal((M, MB, SEQ, D)).astype(np.float32))


def _jax_stage(sp, x):
    return jnp.tanh(x @ sp["w"])


def _stage(sp, x):
    return torch.tanh(x @ sp["w"])


def _jax_head(io, y, t, m):
    logits = y @ io["emb"].T          # tied: the embedding is the head
    lse = jax.nn.logsumexp(logits, -1)
    tl = jnp.take_along_axis(logits, t[..., None], -1)[..., 0]
    return jnp.sum((lse - tl) * m), jnp.sum(m)


def _head(io, y, t, m):
    logits = y @ io["emb"].T
    lse = torch.logsumexp(logits, -1)
    tl = logits.gather(-1, t.long()[..., None])[..., 0]
    return ((lse - tl) * m).sum(), m.sum()


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (jax_create_mesh(axes, devices=jax.devices()[:n]),
            create_mesh(axes, devices=["cpu"] * n))


def test_split_stages():
    p = {"w": torch.arange(8.0).reshape(8, 1)}
    assert tpipe.split_stages(p, 4)["w"].shape == (4, 2, 1)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.split_stages(p, 3)


def test_pipeline_apply_matches_jax(toy):
    jmesh, mesh = _meshes({"pp": S})
    want = jpipe.pipeline_apply(_jax_stage, {"w": jnp.asarray(toy["w"])},
                                jnp.asarray(toy["x"]), mesh=jmesh)
    w = torch.from_numpy(toy["w"]).requires_grad_(True)
    got = tpipe.pipeline_apply(_stage, {"w": w}, torch.from_numpy(toy["x"]),
                               mesh=mesh)
    _close(got.detach().numpy(), np.asarray(want))
    # differentiable: the gradient of the GPipe forward is JAX's
    jgrad = jax.grad(lambda p: jnp.sum(jpipe.pipeline_apply(
        _jax_stage, p, jnp.asarray(toy["x"]), mesh=jmesh) ** 2))(
        {"w": jnp.asarray(toy["w"])})
    (gw,) = torch.autograd.grad(got.square().sum(), [w])
    _close(gw.numpy(), np.asarray(jgrad["w"]), rtol=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(_stage, {"w": w}, torch.zeros(2, 1, 1, D),
                             mesh=mesh)


@pytest.mark.parametrize("embed", [False, True])
def test_pipeline_value_and_grad_matches_jax(toy, embed):
    """1F1B with and without embed_fn: loss and weight sums, the stage
    gradients, the io gradients (with embed_fn the embedding's gradient
    from the head and from the lookup in one leaf) and the input's."""
    jmesh, mesh = _meshes({"pp": S})
    xs = toy["tok"] if embed else toy["x"]
    (jl, jw), (jds, jdi, jdx) = jpipe.pipeline_value_and_grad(
        _jax_stage, _jax_head, {"w": jnp.asarray(toy["w"])},
        {"emb": jnp.asarray(toy["emb"])}, jnp.asarray(xs),
        jnp.asarray(toy["tgt"]), jnp.asarray(toy["msk"]), mesh=jmesh,
        embed_fn=(lambda io, t: io["emb"][t]) if embed else None)
    (tl, tw), (tds, tdi, tdx) = tpipe.pipeline_value_and_grad(
        _stage, _head, {"w": torch.from_numpy(toy["w"])},
        {"emb": torch.from_numpy(toy["emb"])}, torch.from_numpy(xs),
        torch.from_numpy(toy["tgt"]), torch.from_numpy(toy["msk"]),
        mesh=mesh,
        embed_fn=(lambda io, t: io["emb"][t.long()]) if embed else None)
    _close(float(tl), float(jl))
    assert float(tw) == float(jw) == toy["msk"].sum()
    _close(tds["w"].numpy(), np.asarray(jds["w"]), rtol=1e-4)
    _close(tdi["emb"].numpy(), np.asarray(jdi["emb"]), rtol=1e-4)
    if embed:
        assert tdx is None and jdx is None
    else:
        _close(tdx.numpy(), np.asarray(jdx), rtol=1e-4)


def test_pipeline_value_and_grad_takes_one_tree_per_stage(toy):
    """Stage parameters as a list of per-stage trees give the stacked
    form's gradients, per stage; a wrong number of trees raises."""
    _, mesh = _meshes({"pp": S})
    w = torch.from_numpy(toy["w"])
    args = ({"emb": torch.from_numpy(toy["emb"])},
            torch.from_numpy(toy["x"]), torch.from_numpy(toy["tgt"]),
            torch.from_numpy(toy["msk"]))
    _, (stacked, _, _) = tpipe.pipeline_value_and_grad(
        _stage, _head, {"w": w}, *args, mesh=mesh)
    _, (per, _, _) = tpipe.pipeline_value_and_grad(
        _stage, _head, [{"w": w[s]} for s in range(S)], *args, mesh=mesh)
    for s in range(S):
        assert torch.equal(per[s]["w"], stacked["w"][s])
    with pytest.raises(ValueError, match="stage trees"):
        tpipe.pipeline_value_and_grad(_stage, _head, [{"w": w[0]}], *args,
                                      mesh=mesh)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.llama_tiny(VOCAB), dtype="float32")
    tcfg = dataclasses.replace(tllama.llama_tiny(VOCAB), dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, params


def test_llama_forward_pipelined_matches_jax(tiny):
    jcfg, tcfg, jparams, params = tiny
    jmesh, mesh = _meshes({"pp": 2})
    tokens = np.random.default_rng(1).integers(0, VOCAB, (4, 16)).astype(
        np.int32)
    want = jpipe.llama_forward_pipelined(jcfg, jparams, jnp.asarray(tokens),
                                         mesh=jmesh, n_microbatches=4)
    got = tpipe.llama_forward_pipelined(tcfg, params,
                                        torch.from_numpy(tokens), mesh=mesh,
                                        n_microbatches=4)
    _close(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    plain = tllama.forward(tcfg, params, torch.from_numpy(tokens))
    _close(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.llama_forward_pipelined(tcfg, params,
                                      torch.from_numpy(tokens), mesh=mesh,
                                      n_microbatches=3)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _pp_trainers(tiny):
    jcfg, tcfg, _, _ = tiny
    axes = {"pp": 2, "dp": 2, "fsdp": 2}
    kw = dict(strategy="pp_fsdp", learning_rate=1e-3, warmup_steps=1,
              total_steps=50, n_microbatches=4)
    jmesh, mesh = _meshes(axes)
    jt = JaxTrainer(jcfg, JaxTrainConfig(**kw), mesh=jmesh)
    assert jt.pp_axis == "pp"
    jstate = jt.init_state(jax.random.key(0))
    tr = Trainer(tcfg, TrainConfig(**kw), mesh=mesh, device="cpu")
    assert tr.pp_axis == "pp"
    state = place_tree(TrainState.create(convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jstate.params), device="cpu"),
        tr.optimizer), tr.state_shardings())
    return jt, jstate, tr, state


def test_pp_fsdp_trainer_matches_jax_trainer(tiny):
    """3 steps of pp_fsdp on {pp 2, dp 2, fsdp 2}, 4 microbatches of 4
    rows (one per data rank): losses and grad norms at 1e-4 relative,
    the final parameters within 2e-4, and every rank's chunk of them
    equal to JAX's shard within 2e-4."""
    jt, jstate, tr, state = _pp_trainers(tiny)
    batch = np.random.default_rng(2).integers(0, VOCAB, (16, 17)).astype(
        np.int32)
    for step in range(3):
        jstate, jm = jt.train_step(jstate, jnp.asarray(batch))
        state, tm = tr.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            _close(float(tm[k]), float(jm[k]), rtol=1e-4, atol=0,
                   msg=f"{k} {step}")
    flat = list(jt.mesh.devices.ravel())
    final = dict(_named(jstate.params))
    for name, st in _named(state.params):
        _close(st.unshard().detach().numpy(), np.asarray(final[name]),
               rtol=0, atol=2e-4, msg=name)
        for shard in final[name].addressable_shards:
            _close(st.chunks[flat.index(shard.device)].detach().numpy(),
                   np.asarray(shard.data), rtol=0, atol=2e-4, msg=name)


def test_pp_backward_reading_the_wrong_stash_slot_fails(tiny, monkeypatch):
    """Control: a backward slot that reads the previous microbatch's
    stashed input gives gradients far from the schedule's own (which the
    test above holds to JAX's)."""
    _, _, tr, state = _pp_trainers(tiny)
    batch = np.random.default_rng(2).integers(0, VOCAB, (16, 17)).astype(
        np.int32)
    _, want = tr.loss_and_grads(state.params, batch)
    monkeypatch.setattr(tpipe, "_read_slot",
                        lambda b, window: max(b - 1, 0) % window)
    _, bad = tr.loss_and_grads(state.params, batch)
    want, bad = dict(_named(want)), dict(_named(bad))
    errs = {n: float((bad[n].unshard() - w.unshard()).abs().max()
                     / w.unshard().abs().max()) for n, w in want.items()}
    assert max(errs.values()) > 0.05, errs


@pytest.mark.parametrize("cfg_kw,kw,mesh_axes,error", [
    ({}, {"fused_loss": True}, {"pp": 2}, "redundant"),
    ({"n_layers": 3}, {}, {"pp": 2}, "not divisible"),
    ({}, {"loss_fn": True}, {"pp": 2}, "loss_fn"),
])
def test_pipeline_errors_match_jax(tiny, cfg_kw, kw, mesh_axes, error):
    """JAX's refusals under pp: fused_loss, layers that do not divide,
    a custom loss; and a batch the microbatches do not divide."""
    jcfg, tcfg, _, _ = tiny
    jcfg, tcfg = (dataclasses.replace(c, **cfg_kw) for c in (jcfg, tcfg))
    loss_fn = kw.pop("loss_fn", None) and (lambda cfg, p, b: 0.0)
    jmesh, mesh = _meshes(mesh_axes)
    with pytest.raises(ValueError, match=error):
        JaxTrainer(jcfg, JaxTrainConfig(strategy="pp_fsdp", **kw),
                   mesh=jmesh, loss_fn=loss_fn)
    with pytest.raises(ValueError, match=error):
        Trainer(tcfg, TrainConfig(strategy="pp_fsdp", **kw), mesh=mesh,
                device="cpu", loss_fn=loss_fn)


def test_pipeline_refuses_gpt_and_an_indivisible_batch(tiny):
    _, tcfg, _, params = tiny
    _, mesh = _meshes({"pp": 2})
    with pytest.raises(ValueError, match="llama family only"):
        Trainer(tgpt.gpt_tiny(VOCAB), TrainConfig(strategy="pp_fsdp"),
                mesh=mesh, device="cpu")
    tr = Trainer(tcfg, TrainConfig(strategy="pp_fsdp", n_microbatches=3),
                 mesh=mesh, device="cpu")
    state = TrainState.create(params, tr.optimizer)
    batch = np.zeros((4, 9), np.int32)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        tr.train_step(state, batch)
