"""The trainer over a placed state (``train/spmd.py``) against JaxTrainer,
on the CPU.

JaxTrainer runs one GSPMD step over JAX's 8 CPU devices; the port runs
the same step rank by rank on a mesh of the same shape whose places are
all the CPU. From the same float32 weights, 3 steps must give the same
losses and grad norms (1e-4 relative), the same final parameters (2e-4
absolute, as ``test_torch_train.py`` holds the one-card trainer), and
every rank's chunk of the final parameters and Adam moments must equal
JAX's shard on the device at that place (2e-4). Faults of the per-rank
step (a tp block without the psum after ``wo``, an fsdp gather with two
chunks swapped) must move the gradients far from the right ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.parallel.sharding import ShardedTensor, place_tree
from ray_tpu_torch.train import spmd
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

VOCAB = 128
FAMILIES = {"llama": (jllama, tllama, "llama_tiny"),
            "gpt": (jgpt, tgpt, "gpt_tiny"),
            "bert": (jbert, tbert, "bert_tiny")}


def _configs(family):
    jmod, tmod, preset = FAMILIES[family]
    return (dataclasses.replace(getattr(jmod, preset)(VOCAB),
                                dtype="float32"),
            dataclasses.replace(getattr(tmod, preset)(VOCAB),
                                dtype="float32"))


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (jax_create_mesh(axes, devices=jax.devices()[:n]),
            create_mesh(axes, devices=["cpu"] * n))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _mlm_loss(module):
    def loss_fn(model_cfg, params, batch):
        return module.mlm_loss(model_cfg, params, batch["tokens"],
                               batch["targets"],
                               attention_mask=batch["attention_mask"],
                               loss_mask=batch["loss_mask"])
    return loss_fn


def _batch(family, b, seed=9):
    """Tokens [b, 33], or bert's masked-LM batch over padded rows."""
    rng = np.random.default_rng(seed)
    if family != "bert":
        return rng.integers(0, VOCAB, (b, 33)).astype(np.int32)
    targets = rng.integers(4, VOCAB, (b, 16)).astype(np.int32)
    mask = rng.random((b, 16)) < 0.3
    lengths = rng.integers(8, 17, b)
    attn = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int32)
    return {"tokens": np.where(mask, 3, targets).astype(np.int32),
            "targets": targets, "loss_mask": mask & (attn > 0),
            "attention_mask": attn}


def _trainers(family, axes, strategy, **kw):
    """JaxTrainer and the port's Trainer on meshes of ``axes``, the port's
    state placed from JAX's initial weights."""
    jcfg, tcfg = _configs(family)
    jmesh, mesh = _meshes(axes)
    kw = dict(mesh_axes=axes, strategy=strategy, learning_rate=1e-3,
              warmup_steps=2, total_steps=50, **kw)
    hooks = ((_mlm_loss(jbert), _mlm_loss(tbert)) if family == "bert"
             else (None, None))
    jt = JaxTrainer(jcfg, JaxTrainConfig(**kw), mesh=jmesh, loss_fn=hooks[0])
    jstate = jt.init_state(jax.random.key(0))
    tr = Trainer(tcfg, TrainConfig(**kw), mesh=mesh, device="cpu",
                 loss_fn=hooks[1])
    params = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jstate.params), device="cpu")
    state = place_tree(TrainState.create(params, tr.optimizer),
                       tr.state_shardings())
    return jt, jstate, tr, state


def _check_chunks(jarr, st, jmesh, name, atol=2e-4):
    flat = list(jmesh.devices.ravel())
    for shard in jarr.addressable_shards:
        got = st.chunks[flat.index(shard.device)].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(shard.data), rtol=0,
                                   atol=atol, err_msg=name)


def _run(family, axes, strategy, steps=3, **kw):
    jt, jstate, tr, state = _trainers(family, axes, strategy, **kw)
    batch = _batch(family, 8)
    jbatch = jax.tree.map(jnp.asarray, batch)
    for step in range(steps):
        jstate, jm = jt.train_step(jstate, jbatch)
        state, tm = tr.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
    return jt, jstate, tr, state


@pytest.mark.parametrize("axes,strategy,kw", [
    ({"fsdp": 4}, "fsdp", {}),
    ({"dp": 2, "fsdp": 2, "tp": 2}, "fsdp_tp", {}),
    ({"dp": 2, "fsdp": 2, "tp": 2}, "fsdp_tp",
     {"fused_loss": True, "loss_chunk": 16}),
    ({"fsdp": 2, "sp": 2, "tp": 2}, "fsdp_tp_sp", {}),
    ({"dp": 2, "tp": 2}, "tp", {}),
])
def test_llama_trainer_matches_jax_trainer_on_mesh(axes, strategy, kw):
    """3 steps: losses, grad norms, final parameters and every rank's
    chunk of the final parameters and Adam moments."""
    jt, jstate, tr, state = _run("llama", axes, strategy, **kw)
    assert tr.attn_impl == jt.attn_impl
    adam = jstate.opt_state[1][0]
    for tree, jtree in ((state.params, jstate.params),
                        (state.opt_state["mu"], adam.mu),
                        (state.opt_state["nu"], adam.nu)):
        jleaves = dict(_named(jtree))
        for name, st in _named(tree):
            assert isinstance(st, ShardedTensor)
            np.testing.assert_allclose(st.unshard().detach().numpy(),
                                       np.asarray(jleaves[name]), rtol=0,
                                       atol=2e-4, err_msg=name)
            _check_chunks(jleaves[name], st, jt.mesh, name)
    assert state.step == 3 and state.opt_state["count"] == 3


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_gpt_and_bert_train_under_fsdp(family):
    """gpt (next-token loss, each data rank its chunk) and bert (the
    mlm_loss hook on the whole batch) under fsdp on {fsdp 4}, 3 steps
    against JaxTrainer. The key third of the fused qkv bias has an
    exactly-zero true gradient (rounding noise that Adam turns into
    steps of about lr: ``test_torch_models.py``): each run moves it by
    at most lr * steps, so the runs part there by at most twice that,
    in place of the 2e-4 bound."""
    jt, jstate, tr, state = _run(family, {"fsdp": 4}, "fsdp")
    jleaves = dict(_named(jstate.params))
    for name, st in _named(state.params):
        got, want = st.unshard().detach().numpy(), np.asarray(jleaves[name])
        if name == "blocks.bqkv":
            d = got.shape[-1] // 3
            k = slice(d, 2 * d)
            assert np.abs(got[..., k] - want[..., k]).max() <= 2 * 3e-3
            got, want = (np.concatenate([a[..., :d], a[..., 2 * d:]], -1)
                         for a in (got, want))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4,
                                   err_msg=name)


def test_init_state_places_and_training_keeps_the_sharing():
    """init_state on a mesh of several places gives placed leaves (views:
    the placed state costs the unplaced bytes); on one place the tensors
    themselves. After steps, replicated places still share one tensor."""
    _, tcfg = _configs("llama")
    _, mesh = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    tr = Trainer(tcfg, TrainConfig(strategy="fsdp_tp", warmup_steps=1),
                 mesh=mesh, device="cpu")
    state = tr.init_state(seed=0)
    assert all(isinstance(t, ShardedTensor)
               for t in tree_leaves(state.params))
    one = Trainer(tcfg, TrainConfig(), device="cpu").init_state(seed=0)
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(one.params))
    for name, st in _named(state.params):
        assert torch.equal(st.unshard(), dict(_named(one.params))[name])
    batch = _batch("llama", 4)
    for _ in range(2):
        state, m = tr.train_step(state, batch)
    wq = state.params["blocks"]["wq"]
    assert wq.chunks[0] is wq.chunks[4] and len(wq.distinct()) == 4
    bases = {c.untyped_storage().data_ptr() for c in wq.chunks}
    assert len(bases) == 1
    assert np.isfinite(float(m["loss"]))


def _grad_errors(got, want) -> dict:
    want = dict(_named(want))
    return {n: float((g.unshard() - want[n]).abs().max()
                     / want[n].abs().max().clamp(min=1e-30))
            for n, g in _named(got)}


def test_placed_gradients_equal_the_one_place_gradients(monkeypatch):
    """loss_and_grads under fsdp_tp on {dp 2, fsdp 2, tp 2} equals the
    one-place gradient (and a plain tree gets global gradients back);
    without the psum after wo, or with two chunks of every fsdp gather
    along a weight's rows swapped, some gradient moves by more than half
    its scale."""
    _, tcfg = _configs("llama")
    params = tllama.init_params(tcfg, seed=1, device="cpu")
    batch = _batch("llama", 4)
    one = Trainer(tcfg, TrainConfig(), device="cpu")
    loss, want = one.loss_and_grads(params, batch)
    _, mesh = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    tr = Trainer(tcfg, TrainConfig(strategy="fsdp_tp"), mesh=mesh,
                 device="cpu")
    placed = place_tree(params, tr.state_shardings().params)
    got_loss, got = tr.loss_and_grads(placed, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    assert max(_grad_errors(got, want).values()) < 1e-4
    _, plain = tr.loss_and_grads(params, batch)
    assert all(isinstance(g, torch.Tensor) for g in tree_leaves(plain))

    monkeypatch.setattr(spmd, "reduce_attention", lambda parts: parts)
    _, bad = tr.loss_and_grads(placed, batch)
    assert max(_grad_errors(bad, want).values()) > 0.5
    monkeypatch.undo()

    # swapped in the gathers along a weight's rows only: a swap in every
    # gather permutes the model dimension alike in every weight, which
    # the function cannot see once no gather cuts the vocabulary
    def swapped(xs, gather_axis=0, **kw):
        xs = list(xs)
        if gather_axis == 0:
            xs[0], xs[1] = xs[1], xs[0]
        return collectives.all_gather(xs, gather_axis=gather_axis, **kw)
    monkeypatch.setattr(spmd, "all_gather", swapped)
    _, bad = tr.loss_and_grads(placed, batch)
    assert max(_grad_errors(bad, want).values()) > 0.5


def test_batch_must_divide_over_the_data_ranks():
    _, tcfg = _configs("llama")
    _, mesh = _meshes({"fsdp": 4})
    tr = Trainer(tcfg, TrainConfig(strategy="fsdp"), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tr.train_step(tr.init_state(), _batch("llama", 6))
