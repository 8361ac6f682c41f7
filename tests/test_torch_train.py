"""The port's training path against ray_tpu's, on the CPU.

Weights come from JAX's ``init_params`` and carry across through
``convert.params_from_numpy``; batches come from numpy seeds. The model
runs in float32 at ``llama_tiny`` widths. Tolerances: values and
gradients of one loss at 1e-5 relative (float32, summation order only);
trainer losses and gradient norms at 1e-4 relative over 5 steps; final
parameters at 2e-4 absolute (Adam divides each moment by the root of the
second one, so float32 rounding differences in tiny gradients become
parameter differences of order lr x 1e-2). The trainer's step on the
card is covered by the test marked ``cuda`` (skipped without one) and by
chip_smoke.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.optim import (AdamW, tree_leaves,
                                       warmup_cosine_decay_schedule)
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

VOCAB = 128


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.llama_tiny(VOCAB), dtype="float32")
    tcfg = dataclasses.replace(tllama.llama_tiny(VOCAB), dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jparams


def _port_params(tcfg, jparams):
    return convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _batch(b=8, s=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (b, s + 1)).astype(np.int32)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# fused cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["padding", "mask_and_z_loss",
                                  "uneven_chunks"])
def test_fused_cross_entropy_matches_jax(tiny, case):
    """Value and gradients with respect to hidden and the head against
    JAX's fused_cross_entropy (jax.value_and_grad)."""
    jcfg, tcfg, jparams = tiny
    rng = np.random.default_rng(1)
    b, s, d = 2, 48, jcfg.d_model
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    targets = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    mask, z_loss, chunk = None, 0.0, 32
    if case == "padding":
        targets[:, 40:] = -1
    elif case == "mask_and_z_loss":
        mask = (rng.random((b, s)) > 0.3).astype(np.float32)
        z_loss = 1e-2
    else:
        chunk = 40   # 96 rows: two whole chunks and a padded one

    def jloss(h, head):
        p = dict(jparams, lm_head=head)
        return jllama.fused_cross_entropy(
            jcfg, p, h, jnp.asarray(targets),
            mask=None if mask is None else jnp.asarray(mask), chunk=chunk,
            z_loss=z_loss)

    want, (wh, whead) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jparams["lm_head"])
    params = _port_params(tcfg, jparams)
    th = torch.from_numpy(hidden).requires_grad_()
    params["lm_head"].requires_grad_()
    got = tllama.fused_cross_entropy(
        tcfg, params, th, torch.from_numpy(targets).long(),
        mask=None if mask is None else torch.from_numpy(mask), chunk=chunk,
        z_loss=z_loss)
    gh, ghead = torch.autograd.grad(got, (th, params["lm_head"]))
    _close(float(got.detach()), float(want), msg="loss")
    _close(gh.numpy(), wh, atol=1e-7, msg="d hidden")
    _close(ghead.numpy(), whead, atol=1e-7, msg="d head")


def test_fused_loss_matches_dense_loss(tiny):
    """The chunked loss and its gradients equal the dense logits path of
    the same model (forward + cross_entropy_loss)."""
    _, tcfg, jparams = tiny
    params = _port_params(tcfg, jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = torch.from_numpy(_batch(2, 40)).long()
    hidden = tllama.forward_hidden(tcfg, params, batch[:, :-1])
    fused = tllama.fused_cross_entropy(tcfg, params, hidden, batch[:, 1:],
                                       chunk=32)
    dense = tllama.cross_entropy_loss(
        tllama.forward(tcfg, params, batch[:, :-1]), batch[:, 1:])
    _close(float(fused.detach()), float(dense.detach()))
    for g, w in zip(torch.autograd.grad(fused, leaves),
                    torch.autograd.grad(dense, leaves)):
        _close(g.numpy(), w.numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg, params, batch, attn_impl):
    leaves = tree_leaves(params)
    hidden = tllama.forward_hidden(cfg, params, batch[:, :-1],
                                   attn_impl=attn_impl)
    loss = tllama.fused_cross_entropy(cfg, params, hidden, batch[:, 1:],
                                      chunk=64)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["full", "dots", "attn", "dots_attn"])
def test_remat_policy_same_gradients_and_flash_calls(tiny, remat):
    """Every policy gives the gradients of "none"; the flash forward runs
    L times under attn/dots_attn (its out and lse are saved, so the
    backward never reruns it) and 2L times under full/dots."""
    _, tcfg, jparams = tiny
    params = _port_params(tcfg, jparams)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = torch.from_numpy(_batch(2, 256, seed=2)).long()
    _, want = _loss_and_grads(tcfg, params, batch, "flash")
    cfg = dataclasses.replace(tcfg, remat=remat)
    calls = fa.flash_fwd.calls
    _, got = _loss_and_grads(cfg, params, batch, "flash")
    n = tcfg.n_layers
    assert fa.flash_fwd.calls - calls == (n if "attn" in remat else 2 * n)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), atol=1e-7)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_matmuls_not_batched_products(tiny):
    """Counted during the backward with reference attention: "dots" reruns
    no x @ W product (aten.mm) but reruns attention's batched products
    (aten.bmm), as checkpoint_dots_with_no_batch_dims does; "full" reruns
    both."""
    _, tcfg, jparams = tiny
    params = _port_params(tcfg, jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = torch.from_numpy(_batch(2, 64, seed=3)).long()
    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss = tllama.fused_cross_entropy(
            cfg, params, tllama.forward_hidden(cfg, params, batch[:, :-1],
                                               attn_impl="reference"),
            batch[:, 1:], chunk=64)
        with _CountOps() as mode:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (mode.counts.get(torch.ops.aten.mm.default, 0),
                         mode.counts.get(torch.ops.aten.bmm.default, 0))
    # full reruns wq, wk, wv, wo, w_gate and w_up (the recompute stops
    # once the backward's inputs exist, before the last product, w_down)
    assert counts["dots"][0] == counts["none"][0]
    assert counts["full"][0] >= counts["none"][0] + 6 * tcfg.n_layers
    assert counts["dots"][1] > counts["none"][1]
    assert counts["full"][1] == counts["dots"][1]


def test_unknown_remat_policy_raises(tiny):
    _, tcfg, jparams = tiny
    params = _port_params(tcfg, jparams)
    params["embedding"].requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        tllama.forward_hidden(dataclasses.replace(tcfg, remat="offload"),
                              params, torch.zeros((1, 8), dtype=torch.long))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(2, 50), (10, 11), (0, 20)])
def test_schedule_matches_optax(warmup, total):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=lr * 0.1)
    got = warmup_cosine_decay_schedule(0.0, lr, warmup,
                                       max(total, warmup + 1), lr * 0.1)
    for step in (0, 1, warmup, warmup + 1, total // 2, total, total + 5):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12), step
    assert got(0) == (0.0 if warmup else lr)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_adamw_update_matches_optax(max_norm):
    """Three updates of the clipped AdamW against optax's chain, clipping
    (max_norm 0.1) and not (100); the grad norm is the one before
    clipping."""
    rng = np.random.default_rng(4)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 2, 5)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 1e-3)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(sched, b1=0.9, b2=0.95, weight_decay=0.1))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tparams = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    opt = AdamW(warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 1e-3),
                max_grad_norm=max_norm, b1=0.9, b2=0.95, weight_decay=0.1)
    tstate = opt.init(tparams)
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                             .astype(np.float32), params)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.update(tree_leaves(tparams),
                          [torch.from_numpy(g) for g in
                           jax.tree.leaves(grads)], tstate)
        _close(float(norm), float(optax.global_norm(grads)), msg="norm")
        for g, w in zip(tree_leaves(tparams), jax.tree.leaves(jp)):
            _close(g.numpy(), w, atol=1e-7, msg=f"step {step}")
    assert tstate["count"] == 3


def test_moments_keep_the_parameter_dtype():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    opt = AdamW(lambda c: 1e-3, max_grad_norm=1.0, b1=0.9, b2=0.95,
                weight_decay=0.1)
    state = opt.init(params)
    opt.update([params["w"]], [torch.full((4, 4), 0.5, dtype=torch.bfloat16)],
               state)
    assert state["mu"]["w"].dtype == torch.bfloat16
    assert state["nu"]["w"].dtype == torch.bfloat16
    assert params["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# trainer against JaxTrainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_loss", [False, True])
def test_trainer_matches_jax_trainer(tiny, fused_loss):
    """First-step loss and grad norm, then 5 steps of losses and the final
    parameters, against JaxTrainer on a one-axis mesh of JAX's 8 CPU
    devices (batch 8), same TrainConfig."""
    jcfg, tcfg, jparams = tiny
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50,
              fused_loss=fused_loss, loss_chunk=64)
    jt = JaxTrainer(jcfg, JaxTrainConfig(strategy="dp", **kw),
                    mesh=create_mesh({"dp": 8}))
    jstate = jt.init_state(jax.random.key(0))
    trainer = Trainer(tcfg, TrainConfig(**kw), device="cpu")
    state = TrainState.create(_port_params(tcfg, jax.tree.map(
        np.asarray, jstate.params)), trainer.optimizer)
    batch = _batch(8, 32, seed=5)
    jl, tl, jn, tn = [], [], [], []
    for _ in range(5):
        jstate, jm = jt.train_step(jstate, jnp.asarray(batch))
        state, tm = trainer.train_step(state, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        jn.append(float(jm["grad_norm"]))
        tn.append(float(tm["grad_norm"]))
    assert state.step == int(jstate.step) == 5
    _close(tl, jl, rtol=1e-4, msg="losses")
    _close(tn, jn, rtol=1e-4, msg="grad norms")
    assert tl[-1] < tl[0]
    final = jax.tree.map(np.asarray, jstate.params)
    for (name, got), want in zip(
            ((k, v) for k, v in _named(state.params)),
            jax.tree.leaves(final)):
        _close(got.detach().numpy(), want, rtol=0, atol=2e-4, msg=name)


def _named(tree, prefix=""):
    """(name, leaf) in JAX's leaf order (keys sorted, as jax.tree does)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _toy_trainer(tcfg, **kw):
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50,
                      **kw)
    return Trainer(tcfg, cfg, device="cpu")


def test_train_loss_decreases(tiny):
    _, tcfg, _ = tiny
    trainer = _toy_trainer(tcfg)
    state = trainer.init_state(seed=0)
    batch = _batch(8, 16)
    losses = []
    for _ in range(10):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses
    assert state.step == 10


def test_padding_masked_in_loss(tiny):
    """-1 targets drop out of the mean: a batch whose later targets are
    padding gives the loss of its unpadded prefix."""
    _, tcfg, jparams = tiny
    trainer = _toy_trainer(tcfg)
    params = _port_params(tcfg, jparams)
    batch = torch.from_numpy(_batch(8, 16)).long()
    padded = batch.clone()
    padded[:, 9:] = -1   # targets 8.. are padding
    loss = trainer._loss_fn(params, padded)
    want = tllama.cross_entropy_loss(
        tllama.forward(tcfg, params, batch[:, :8]), batch[:, 1:9])
    assert torch.isfinite(loss)
    _close(float(loss), float(want))
    state = TrainState.create(params, trainer.optimizer)
    state, m = trainer.train_step(state, padded)
    assert np.isfinite(float(m["loss"]))


def test_checkpoint_save_restore(tiny, tmp_path):
    _, tcfg, _ = tiny
    trainer = _toy_trainer(tcfg)
    state = trainer.init_state(seed=0)
    batch = _batch(8, 16)
    state, _ = trainer.train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(state.step, state)
    mgr.wait()
    assert mgr.latest_step() == 1
    restored = mgr.restore(target=state, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(restored.params)):
        assert torch.equal(a, b)
    assert restored.opt_state["count"] == state.opt_state["count"] == 1
    # the restored state continues training identically
    _, m1 = trainer.train_step(state, batch)
    _, m2 = trainer.train_step(restored, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    mgr.close()


def test_async_checkpoint_is_the_state_at_save(tiny, tmp_path):
    """An asynchronous save, then a step that updates the state in place:
    the checkpoint holds the state as it was when save() returned."""
    _, tcfg, _ = tiny
    trainer = _toy_trainer(tcfg)
    state = trainer.init_state(seed=1)
    batch = _batch(8, 16)
    state, _ = trainer.train_step(state, batch)
    snapshot = [t.detach().clone() for t in tree_leaves(state.params)]
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(1, state)
    state, _ = trainer.train_step(state, batch)
    mgr.wait()
    restored = mgr.restore(1, device="cpu")
    assert restored.step == 1
    for want, got, now in zip(snapshot, tree_leaves(restored.params),
                              tree_leaves(state.params)):
        assert torch.equal(got, want)
    assert not all(torch.equal(n, w) for n, w in
                   zip(tree_leaves(state.params), snapshot))
    with pytest.raises(ValueError, match="target"):
        mgr.restore(1, target={"params": {}}, device="cpu")
    mgr.close()


def test_checkpoint_topk_retention(tiny, tmp_path):
    _, tcfg, jparams = tiny
    trainer = _toy_trainer(tcfg)
    state = TrainState.create(_port_params(tcfg, jparams), trainer.optimizer)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                            async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, force=True)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    mgr.close()


@pytest.mark.parametrize("kw", [
    {"mesh_axes": {"dp": 2}},
    {"n_microbatches": 4},
    {"mesh_axes": {"fsdp": -1, "tp": 4}},
])
def test_multi_card_configs_are_refused(tiny, kw):
    _, tcfg, _ = tiny
    with pytest.raises(NotImplementedError):
        Trainer(tcfg, TrainConfig(**kw), device="cpu")


def test_custom_loss_fn_hook(tiny):
    """loss_fn(model_cfg, params, batch) replaces the default loss; a dict
    batch goes to the device as it is."""
    _, tcfg, jparams = tiny
    seen = {}

    def loss_fn(cfg, params, batch):
        seen["keys"] = sorted(batch)
        hidden = tllama.forward_hidden(cfg, params, batch["tokens"])
        return hidden.square().mean()

    trainer = Trainer(tcfg, TrainConfig(learning_rate=1e-3), device="cpu",
                      loss_fn=loss_fn)
    state = TrainState.create(_port_params(tcfg, jparams), trainer.optimizer)
    batch = {"tokens": _batch(2, 8)[:, :8], "labels": np.zeros(2, np.int32)}
    state, m = trainer.train_step(state, batch)
    assert seen["keys"] == ["labels", "tokens"] and np.isfinite(
        float(m["loss"]))
    with pytest.raises(ValueError, match="fused_loss"):
        Trainer(tcfg, TrainConfig(fused_loss=True), device="cpu",
                loss_fn=loss_fn)


def test_inference_on_trained_params_builds_no_graph(tiny):
    """Parameters the trainer marked as requiring gradients go to
    generate() as they are: it runs under inference mode, keeps no
    autograd graph and gives the tokens of detached parameters."""
    _, tcfg, _ = tiny
    trainer = _toy_trainer(tcfg)
    state = trainer.init_state(seed=2)
    state, _ = trainer.train_step(state, _batch(2, 16))
    assert all(t.requires_grad for t in tree_leaves(state.params))
    prompts = torch.from_numpy(_batch(2, 6)[:, :6]).int() + 1
    sampling = tdec.SamplingParams(temperature=0.0, max_new_tokens=4)
    got = tdec.generate(tcfg, state.params, prompts, sampling=sampling)
    detached = {k: (v.detach() if not isinstance(v, dict)
                    else {n: w.detach() for n, w in v.items()})
                for k, v in state.params.items()}
    want = tdec.generate(tcfg, detached, prompts, sampling=sampling)
    assert got.grad_fn is None and not got.requires_grad
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_train_step_through_kernels():
    """One trainer step of a small model on the card: K1 (twice under full
    remat) and the fused backward (K2 and K3) launch once per layer, and
    the loss is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = dataclasses.replace(tllama.llama_tiny(VOCAB), head_dim=64,
                              n_heads=4, n_kv_heads=2, d_model=256,
                              remat="full")
    trainer = Trainer(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1),
                      device="cuda")
    state = trainer.init_state(seed=0)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    state, m = trainer.train_step(state, _batch(2, 256))
    after = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    n = cfg.n_layers
    assert [a - b for a, b in zip(after, before)] == [2 * n, n]
    assert math.isfinite(float(m["loss"]))
