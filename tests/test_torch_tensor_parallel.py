"""Tensor-parallel GPT and BERT, the vocab-parallel embedding and loss,
and the forward over a placed tree with Mixtral's experts over ep
(``train/spmd.py``), against the JAX package on its 8 CPU devices.

In float32 at tiny widths: the trainers take 3 steps from the same
weights (losses and gradient norms within 1e-4 relative, every rank's
chunk of the final parameters and Adam moments within 2e-4 of JAX's
shard at that place, as ``test_torch_spmd.py`` holds them), and the
placed forwards give JAX's jitted forward on JAX's placed tree within
1e-4. Controls: the vocab-parallel loss without the cross-rank exp-sum,
and a per-data-rank MoE capacity on a batch whose first data rank crowds
one expert.
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
from ray_tpu.models import mixtral as jmixtral
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.sharding import PRESETS as JAX_PRESETS
from ray_tpu.parallel.sharding import shard_tree as jax_shard_tree
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmixtral
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.parallel.sharding import PRESETS, place_tree, shard_tree
from ray_tpu_torch.train import spmd
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

VOCAB = 128
# llama's vocabulary in the gather count: no other dimension is 80 = 160/2
LLAMA_VOCAB = 160
MESH = {"dp": 2, "fsdp": 2, "tp": 2}
STEPS = 3
LR = 1e-3
MODULES = {"llama": (jllama, tllama), "gpt": (jgpt, tgpt),
           "bert": (jbert, tbert), "mixtral": (jmixtral, tmixtral)}


def _configs(family, vocab=VOCAB, **overrides):
    jmod, tmod = MODULES[family]
    preset = f"{family}_tiny"
    return tuple(dataclasses.replace(getattr(mod, preset)(vocab),
                                     dtype="float32", **overrides)
                 for mod in (jmod, tmod))


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


def _batch(family, b, vocab=VOCAB, seed=9):
    """Tokens [b, 33] with some -1 padding, or bert's masked-LM batch over
    padded rows."""
    rng = np.random.default_rng(seed)
    if family != "bert":
        tokens = rng.integers(0, vocab, (b, 33)).astype(np.int32)
        tokens[0, -5:] = -1
        return tokens
    targets = rng.integers(4, vocab, (b, 16)).astype(np.int32)
    mask = rng.random((b, 16)) < 0.3
    lengths = rng.integers(8, 17, b)
    attn = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int32)
    return {"tokens": np.where(mask, 3, targets).astype(np.int32),
            "targets": targets, "loss_mask": mask & (attn > 0),
            "attention_mask": attn}


def _check_chunks(jarr, st, jmesh, name, atol=2e-4, keep=None):
    """Every rank's chunk of ``st`` against JAX's shard on the device at
    that place (``keep``: a mask of the global array's entries held)."""
    flat = list(jmesh.devices.ravel())
    for shard in jarr.addressable_shards:
        got = st.chunks[flat.index(shard.device)].detach().numpy()
        want = np.asarray(shard.data)
        if keep is not None:
            held = keep[shard.index]
            got, want = got[held], want[held]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def _key_third(shape):
    """The entries of a fused qkv bias off its key third. That third's
    true gradient is exactly zero (``test_torch_spmd.py``): each run's
    Adam moves it by about lr a step on rounding noise, so the two runs
    part there by at most twice lr times the steps."""
    d = shape[-1] // 3
    keep = np.ones(shape, dtype=bool)
    keep[..., d:2 * d] = False
    return keep


def _train(family, jcfg, tcfg, axes, strategy, batch, **kw):
    """JaxTrainer and the port's Trainer on meshes of ``axes`` from JAX's
    initial weights, ``STEPS`` steps on ``batch``: losses and gradient
    norms within 1e-4 relative each step. Returns both trainers and their
    final states."""
    jmesh, mesh = _meshes(axes)
    kw = dict(mesh_axes=axes, strategy=strategy, learning_rate=LR,
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
    jbatch = jax.tree.map(jnp.asarray, batch)
    for step in range(STEPS):
        jstate, jm = jt.train_step(jstate, jbatch)
        state, tm = tr.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
    return jt, jstate, tr, state


def _check_state(jt, jstate, state):
    """Every rank's chunk of the final parameters and Adam moments
    against JAX's shard (2e-4), the parameters also whole; a fused qkv
    bias off its key third there (``_key_third``), which moves by at most
    2·lr·steps."""
    adam = jstate.opt_state[1][0]
    for tree, jtree, is_params in ((state.params, jstate.params, True),
                                   (state.opt_state["mu"], adam.mu, False),
                                   (state.opt_state["nu"], adam.nu, False)):
        jleaves = dict(_named(jtree))
        for name, st in _named(tree):
            got = st.unshard().detach().numpy()
            want = np.asarray(jleaves[name])
            keep = _key_third(got.shape) if (
                is_params and name == "blocks.bqkv") else None
            if keep is not None:
                assert np.abs(got - want)[~keep].max() <= 2 * LR * STEPS
            held = slice(None) if keep is None else keep
            np.testing.assert_allclose(got[held], want[held], rtol=0,
                                       atol=2e-4, err_msg=name)
            _check_chunks(jleaves[name], st, jt.mesh, name, keep=keep)


@pytest.mark.parametrize("strategy", ["fsdp", "tp", "fsdp_tp"])
def test_gpt_trains_like_jax_on_a_tp_mesh(strategy):
    """gpt_tiny on {dp 2, fsdp 2, tp 2} (``tests/test_gpt.py``'s
    ``test_gpt_trains_sharded``): under fsdp_tp the fused qkv chunk of a
    rank is not whole heads (chunk 0 is all of q and half of k), the
    vocabulary stays cut over tp through the tied head."""
    jcfg, tcfg = _configs("gpt")
    jt, jstate, _, state = _train("gpt", jcfg, tcfg, MESH, strategy,
                                  _batch("gpt", 8))
    _check_state(jt, jstate, state)


def _head_aligned(d, head_dim, heads):
    """The fault of reading the fused qkv as Megatron's head-aligned
    layout, ``[q_h | k_h | v_h]`` head by head."""
    return [[[(3 * h * head_dim + t * head_dim,
               3 * h * head_dim + (t + 1) * head_dim) for h in range(a, z)]
             for a, z in heads] for t in range(3)]


def test_gpt_heads_need_not_divide_tp(monkeypatch):
    """d 160 in 5 heads of 32 on {tp 2}: the ranks run 3 and 2 heads, the
    qkv chunks (240 columns) and wo's row chunks (80 rows) split heads.
    Reading the chunks as head-aligned takes the loss away from JAX's."""
    jcfg, tcfg = _configs("gpt", d_model=160, n_heads=5, d_ff=320)
    step = spmd.RankStep(tgpt, tcfg, _meshes({"tp": 2})[1], PRESETS["tp"])
    assert step.heads == [(0, 3), (3, 5)]
    batch = _batch("gpt", 4)
    jt, jstate, tr, state = _train("gpt", jcfg, tcfg, {"tp": 2}, "tp",
                                   batch)
    _check_state(jt, jstate, state)
    want = float(jt._loss_fn(jstate.params, jnp.asarray(batch)))
    monkeypatch.setattr(spmd, "qkv_columns", _head_aligned)
    loss, _ = tr.loss_and_grads(state.params, batch)
    assert abs(float(loss) - want) > 1e-2 * want


@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
def test_bert_trains_like_jax_under_tp_through_the_hook(strategy):
    """bert_tiny under tp and fsdp_tp on {dp 2, fsdp 2, tp 2} through the
    mlm_loss hook (``tests/test_bert.py``'s
    ``test_bert_trains_through_jax_trainer``): the hook sees the gathered
    parameters."""
    jcfg, tcfg = _configs("bert")
    jt, jstate, _, state = _train("bert", jcfg, tcfg, MESH, strategy,
                                  _batch("bert", 8))
    _check_state(jt, jstate, state)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_gpt_and_bert_build_on_a_tp_mesh(family):
    """On {fsdp 2, tp 2} the trainer builds under fsdp (the tp axis
    idle) and under fsdp_tp (the tp blocks; bert through its hook)."""
    _, tcfg = _configs(family)
    _, mesh = _meshes({"fsdp": 2, "tp": 2})
    hook = _mlm_loss(tbert) if family == "bert" else None
    for strategy, tp in (("fsdp", None), ("fsdp_tp", "tp")):
        tr = Trainer(tcfg, TrainConfig(strategy=strategy), mesh=mesh,
                     device="cpu", loss_fn=hook)
        assert tr._rank_step().tp == tp


def _recording_gathers(monkeypatch) -> list:
    calls = []

    def gather(xs, gather_axis=0, **kw):
        calls.append((gather_axis, tuple(xs[0].shape)))
        return collectives.all_gather(xs, gather_axis=gather_axis, **kw)
    monkeypatch.setattr(spmd, "all_gather", gather)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_llama_vocab_parallel_loss(fused, monkeypatch):
    """llama_tiny under fsdp_tp on {dp 2, fsdp 2, tp 2}, dense and fused
    loss, against JaxTrainer; no gather joins the vocabulary's pieces
    (the embedding and the head are gathered over fsdp only). Without the
    exp-sum over the tp ranks the loss leaves JAX's."""
    jcfg, tcfg = _configs("llama", vocab=LLAMA_VOCAB)
    piece = LLAMA_VOCAB // MESH["tp"]
    calls = _recording_gathers(monkeypatch)
    kw = dict(fused_loss=True, loss_chunk=16) if fused else {}
    batch = _batch("llama", 8, vocab=LLAMA_VOCAB)
    jt, jstate, tr, state = _train("llama", jcfg, tcfg, MESH, "fsdp_tp",
                                   batch, **kw)
    _check_state(jt, jstate, state)
    # the embedding's [80, 64] chunks gathered over fsdp along the model
    # dimension, the head's [64, 80] along its rows; nothing along 80
    assert (1, (piece, 64)) in calls and (0, (64, piece)) in calls
    assert not [c for c in calls if c[1][c[0]] == piece]

    want = float(jt._loss_fn(jstate.params, jnp.asarray(batch)))
    loss, _ = tr.loss_and_grads(state.params, batch)
    np.testing.assert_allclose(float(loss), want, rtol=1e-4)
    monkeypatch.setattr(spmd, "reduce_vocab", lambda parts: parts)
    loss, _ = tr.loss_and_grads(state.params, batch)
    assert abs(float(loss) - want) > 0.1 * want


def test_pp_head_and_embedding_are_vocab_parallel(monkeypatch):
    """The 1F1B pipeline on {pp 2, tp 2} under pp_fsdp: its embed_fn and
    head_fn keep the vocabulary cut (no gather joins its pieces), and the
    loss and gradients equal the one-place trainer's."""
    _, tcfg = _configs("llama", vocab=LLAMA_VOCAB)
    params = tllama.init_params(tcfg, seed=3, device="cpu")
    batch = _batch("llama", 4, vocab=LLAMA_VOCAB)
    loss, want = Trainer(tcfg, TrainConfig(), device="cpu").loss_and_grads(
        params, batch)
    axes = {"pp": 2, "tp": 2}
    calls = _recording_gathers(monkeypatch)
    tr = Trainer(tcfg, TrainConfig(mesh_axes=axes, strategy="pp_fsdp"),
                 mesh=_meshes(axes)[1], device="cpu")
    got_loss, got = tr.loss_and_grads(params, batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = dict(_named(want))
    for name, g in _named(got):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() < 1e-4 * np.abs(w).max(), name
    assert not [c for c in calls if c[1][c[0]] == LLAMA_VOCAB // 2]


def _jax_placed(jmod, jcfg, rules, jmesh):
    params = jmod.init_params(jcfg, jax.random.key(0))
    return params, jax_shard_tree(params, jmod.param_logical_axes(jcfg),
                                  jmesh, rules)


def _port_placed(tmod, tcfg, params, rules, mesh):
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return tparams, shard_tree(tparams, tmod.param_logical_axes(tcfg), mesh,
                               rules)


@pytest.mark.parametrize("family", ["llama", "gpt", "bert"])
def test_placed_forward_matches_jax(family):
    """``placed_forward`` under fsdp_tp on {dp 2, fsdp 2, tp 2} against
    ``jax.jit(family.forward)`` (bert: ``encode``, with padding and token
    types) on JAX's placed tree."""
    jmod, tmod = MODULES[family]
    jcfg, tcfg = _configs(family)
    jmesh, mesh = _meshes(MESH)
    params, jplaced = _jax_placed(jmod, jcfg, JAX_PRESETS["fsdp_tp"], jmesh)
    _, placed = _port_placed(tmod, tcfg, params, PRESETS["fsdp_tp"], mesh)
    tokens = np.random.default_rng(1).integers(0, VOCAB, (4, 16))
    kw = {}
    if family == "bert":
        kw = {"attention_mask": (np.arange(16)[None, :]
                                 < np.array([16, 9, 12, 5])[:, None]),
              "token_type_ids": (np.arange(16)[None, :] >= 8)
              .repeat(4, 0).astype(np.int32)}
    run = jmod.encode if family == "bert" else jmod.forward
    want = jax.jit(lambda p, t, kw: run(jcfg, p, t, **kw))(
        jplaced, jnp.asarray(tokens), {k: jnp.asarray(v)
                                       for k, v in kw.items()})
    got = spmd.placed_forward(
        tmod, tcfg, placed, torch.as_tensor(tokens), mesh=mesh,
        rules=PRESETS["fsdp_tp"],
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _mixtral_tokens(skewed: bool):
    tokens = np.random.default_rng(2).integers(0, VOCAB, (4, 16))
    if skewed:
        # the first data rank's rows (0 and 1) one token throughout: after
        # the first attention their states are equal, so every one of its
        # 32 tokens picks the same two experts
        tokens[:2] = 7
    return tokens


@pytest.mark.parametrize("skewed", [False, True])
def test_mixtral_placed_forward_matches_jax_under_moe(skewed, monkeypatch):
    """Mixtral's forward under moe on {fsdp 2, ep 2, tp 2} against
    ``jax.jit(mixtral.forward)`` on JAX's placed tree: logits and aux loss
    within 1e-4. Each ep place runs only its own 2 of the 4 experts, with
    its half of ``mlp``. On the skewed batch the first data rank crowds
    one expert past a per-rank capacity (capacity_factor·T_rank·k/E = 20
    of its 32 tokens), so the forward of each data rank's rows alone
    leaves JAX's; the global capacity (40) keeps them."""
    jcfg, tcfg = _configs("mixtral")
    axes = {"fsdp": 2, "ep": 2, "tp": 2}
    jmesh, mesh = _meshes(axes)
    params, jplaced = _jax_placed(jmixtral, jcfg, JAX_PRESETS["moe"], jmesh)
    tparams, placed = _port_placed(tmixtral, tcfg, params, PRESETS["moe"],
                                   mesh)
    tokens = _mixtral_tokens(skewed)
    want, want_aux = jax.jit(lambda p, t: jmixtral.forward(
        jcfg, p, t, return_aux_loss=True))(jplaced, jnp.asarray(tokens))
    experts = []
    expert_ffn = spmd._expert_ffn

    def ffn(x, w_gate, w_up, w_down):
        experts.append((tuple(x.shape), tuple(w_gate.shape),
                        tuple(w_down.shape)))
        return expert_ffn(x, w_gate, w_up, w_down)
    monkeypatch.setattr(spmd, "_expert_ffn", ffn)
    got, aux = spmd.placed_forward(
        tmixtral, tcfg, placed, torch.as_tensor(tokens), mesh=mesh,
        rules=PRESETS["moe"], return_aux_loss=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)
    capacity = int(1.25 * 64 * 2 / 4)
    # per layer: 2 ep places x 2 tp places, each 2 experts, mlp 256 / 2
    assert experts == [((2, capacity, 128), (2, 128, 128), (2, 128, 128))
                       ] * (4 * tcfg.n_layers)
    if skewed:
        per_rank = torch.cat([tmixtral.forward(tcfg, tparams,
                                               torch.as_tensor(rows))
                              for rows in np.split(tokens, 2)])
        assert np.abs(per_rank.numpy() - np.asarray(want)).max() > 1e-2
