"""The port's other model families (Mixtral, GPT-2, BERT, ViT), the
trainer's family dispatch and the weight bridge, against ray_tpu on the
CPU.

JAX initializes the weights; they carry across through
``convert.params_from_numpy``. Inputs come from numpy seeds. Every model
runs in float32 at its tiny preset, so the two sides differ only in
float32 summation order. Tolerances: logits, hidden states and losses at
1e-4 absolute and relative (values of order 1 after a few layers);
gradients at 1e-4 relative with an absolute floor of 1e-6 (1e-5 for
Mixtral's, whose router gradient comes through softmax gates that XLA
and PyTorch compute an ulp apart); trainers over 5 steps as in
``test_torch_train.py``: losses and grad norms at 1e-4 relative, final
parameters at 2e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import mixtral as jmixtral
from ray_tpu.models import vit as jvit
from ray_tpu.parallel.mesh import create_mesh
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmixtral
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

VOCAB = 128
FAMILIES = {
    "mixtral": (jmixtral, tmixtral, "mixtral_tiny"),
    "gpt": (jgpt, tgpt, "gpt_tiny"),
    "bert": (jbert, tbert, "bert_tiny"),
    "vit": (jvit, tvit, "vit_tiny"),
}


def _tiny(family, **kw):
    """(JAX config, port config) of a family's tiny preset, float32."""
    jmod, tmod, preset = FAMILIES[family]
    if family == "vit":
        return (dataclasses.replace(jvit.vit_tiny(), **kw),
                dataclasses.replace(tvit.vit_tiny(), **kw))
    jcfg = getattr(jmod, preset)(VOCAB)
    tcfg = getattr(tmod, preset)(VOCAB)
    kw = {"dtype": "float32", **kw}
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _pair(family, seed=0, **kw):
    jcfg, tcfg = _tiny(family, **kw)
    jmod = FAMILIES[family][0]
    jparams = _jax_init(jmod, jcfg, seed)
    return jcfg, jparams, tcfg, _port(tcfg, jparams)


def _jax_init(jmod, jcfg, seed=0):
    return jmod.init_params(jcfg, jax.random.key(seed))


def _port(tcfg, jparams):
    return convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _tokens(shape, seed=1, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _close(got, want, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _named(tree, prefix=""):
    """(name, leaf) in JAX's leaf order (keys sorted, as jax.tree does)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _grad_tree(loss, params):
    """d loss / d params, in the parameters' own tree (zeros for a leaf the
    loss does not use, as jax.grad gives)."""
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     allow_unused=True,
                                     materialize_grads=True))
    return {k: ({n: next(grads) for n in v} if isinstance(v, dict)
                else next(grads)) for k, v in params.items()}


def _requires_grad(params):
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _grads_close(got_tree, want_tree, rtol=1e-4, floor=1e-6):
    """Every gradient leaf within rtol of JAX's, relative to the leaf's
    largest entry (with an absolute floor)."""
    want_leaves = dict(_named(jax.tree.map(np.asarray, want_tree)))
    for name, g in _named(got_tree):
        want = want_leaves[name]
        atol = max(floor, rtol * float(np.abs(want).max()))
        _close(g.detach().numpy(), want, rtol=rtol, atol=atol, msg=name)


# ---------------------------------------------------------------------------
# configs, parameters and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,preset", [
    ("mixtral", "mixtral_8x7b"), ("mixtral", "mixtral_tiny"),
    ("gpt", "gpt2_small"), ("gpt", "gpt2_xl"), ("gpt", "gpt_tiny"),
    ("bert", "bert_base"), ("bert", "bert_large"), ("bert", "bert_tiny"),
    ("vit", "vit_l16"), ("vit", "vit_tiny"),
])
def test_presets_match_jax(family, preset):
    jmod, tmod, _ = FAMILIES[family]
    j = dataclasses.asdict(getattr(jmod, preset)())
    t = dataclasses.asdict(getattr(tmod, preset)())
    if family == "vit":   # a jnp dtype there, a torch dtype here
        assert np.dtype(j.pop("param_dtype")).name == \
            str(t.pop("param_dtype")).split(".")[-1]
    assert j == t


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_layout_matches_jax(family):
    """The port's own init: JAX's names, shapes and dtypes (bf16 for the
    language models, float32 for the router and mlm_bias), and the draws
    repeat for a seed."""
    jmod, tmod, preset = FAMILIES[family]
    jcfg, tcfg = getattr(jmod, preset)(), getattr(tmod, preset)()
    jparams = _jax_init(jmod, jcfg)
    theirs = dict(_named(jparams))
    ours = tmod.init_params(tcfg, seed=0, device="cpu")
    named = dict(_named(ours))
    assert set(named) == set(theirs)
    for name, arr in theirs.items():
        assert tuple(named[name].shape) == arr.shape, name
        assert str(named[name].dtype).split(".")[-1] == arr.dtype.name, name
    again = tmod.init_params(tcfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(ours), tree_leaves(again)))
    assert tmod.num_params(ours) == jmod.num_params(jparams)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_checks_each_familys_tree(family):
    """A foreign tree, a missing leaf and a wrong shape raise; the right
    tree converts bit for bit."""
    jcfg, jparams, tcfg, tparams = _pair(family)
    tree = jax.tree.map(np.asarray, jparams)
    for name, want in _named(tree):
        got = dict(_named(tparams))[name]
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="expected"):
        convert.params_from_numpy(tcfg, {"embedding": np.zeros((2, 2))},
                                  device="cpu")
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != sorted(tree["blocks"])[0]})
    with pytest.raises(ValueError, match="blocks"):
        convert.params_from_numpy(tcfg, missing, device="cpu")
    leaf = sorted(k for k, v in tree.items() if not isinstance(v, dict))[0]
    bad = dict(tree, **{leaf: np.zeros((3,) + tree[leaf].shape)})
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(tcfg, bad, device="cpu")
    # a tree of another family
    other = "gpt" if family != "gpt" else "bert"
    with pytest.raises(ValueError, match="expected"):
        convert.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, _pair(other)[1]), device="cpu")


@pytest.mark.parametrize("family,pinned", [
    ("mixtral", "blocks.router"), ("bert", "mlm_bias")])
def test_converter_keeps_float32_leaves_float32(family, pinned):
    """A bf16 JAX tree holds these leaves in float32; they stay so, with
    and without a dtype cast of the rest."""
    jmod, tmod, preset = FAMILIES[family]
    jparams = _jax_init(jmod, getattr(jmod, preset)(VOCAB))
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = getattr(tmod, preset)(VOCAB)
    for dtype in (None, torch.bfloat16, torch.float32):
        named = dict(_named(convert.params_from_numpy(
            tcfg, tree, device="cpu", dtype=dtype)))
        assert named[pinned].dtype == torch.float32, dtype
        assert named["embedding"].dtype == (dtype or torch.bfloat16)


# ---------------------------------------------------------------------------
# Mixtral
# ---------------------------------------------------------------------------

def test_mixtral_forward_and_aux_match_jax():
    jcfg, jparams, tcfg, tparams = _pair("mixtral")
    toks = _tokens((2, 16))
    want, want_aux = jax.jit(lambda p, t: jmixtral.forward(
        jcfg, p, t, return_aux_loss=True))(jparams, jnp.asarray(toks))
    got, aux = tmixtral.forward(tcfg, tparams, torch.from_numpy(toks).long(),
                                return_aux_loss=True)
    assert got.dtype == torch.float32 and got.shape == (2, 16, VOCAB)
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    assert float(aux) > 0
    _close(tmixtral.forward(tcfg, tparams,
                            torch.from_numpy(toks).long()).numpy(), want)


def _mixtral_loss_and_grads(remat):
    jcfg, jparams, tcfg, tparams = _pair("mixtral")
    toks = _tokens((2, 17), seed=2)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmixtral.loss_fn(jcfg, p, jnp.asarray(inputs),
                                   jnp.asarray(targets))))(jparams)
    cfg = dataclasses.replace(tcfg, remat=remat)
    _requires_grad(tparams)
    loss = tmixtral.loss_fn(cfg, tparams, torch.from_numpy(inputs).long(),
                            torch.from_numpy(targets).long())
    return (loss, jloss), (_grad_tree(loss, tparams), jgrads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_mixtral_loss_and_grads_match_jax(remat):
    """loss_fn and every parameter's gradient against jax.grad, the same
    under each remat policy."""
    (loss, jloss), (gtree, jgrads) = _mixtral_loss_and_grads(remat)
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(gtree, jgrads, floor=1e-5)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_mixtral_remat_dots_saves_unbatched_products_only():
    """Counted during the backward: "dots" reruns no product without a
    batch dim (aten.mm: the projections and the dispatch and combine
    products) and reruns the experts' batched products (aten.bmm), as
    checkpoint_dots_with_no_batch_dims does; "full" reruns both."""
    _, _, tcfg, tparams = _pair("mixtral")
    leaves = tree_leaves(_requires_grad(tparams))
    toks = torch.from_numpy(_tokens((2, 17), seed=3)).long()
    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss = tmixtral.loss_fn(cfg, tparams, toks[:, :-1], toks[:, 1:])
        with _CountOps() as mode:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (mode.counts.get(torch.ops.aten.mm.default, 0),
                         mode.counts.get(torch.ops.aten.bmm.default, 0))
    assert counts["dots"][0] == counts["none"][0]
    assert counts["full"][0] > counts["none"][0]
    # the gate, up and down products of each layer rerun
    assert counts["dots"][1] >= counts["none"][1] + 3 * tcfg.n_layers
    assert counts["full"][1] >= counts["dots"][1]


def test_mixtral_rejects_unknown_remat():
    _, _, tcfg, tparams = _pair("mixtral")
    tparams["embedding"].requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        tmixtral.forward(dataclasses.replace(tcfg, remat="attn"), tparams,
                         torch.zeros((1, 8), dtype=torch.long))


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positions", [False, True])
def test_gpt_forward_matches_jax(positions):
    jcfg, jparams, tcfg, tparams = _pair("gpt")
    toks = _tokens((2, 24))
    pos = (np.arange(24, dtype=np.int32)[None, ::-1] + 3
           if positions else None)
    want = jax.jit(lambda p, t, q: jgpt.forward(jcfg, p, t, positions=q))(
        jparams, jnp.asarray(toks), None if pos is None else jnp.asarray(pos))
    got = tgpt.forward(tcfg, tparams, torch.from_numpy(toks).long(),
                       positions=None if pos is None
                       else torch.from_numpy(pos.copy()).long())
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_gpt_rejects_overlong_sequence():
    _, _, tcfg, tparams = _pair("gpt")
    with pytest.raises(ValueError, match="max_seq_len"):
        tgpt.forward(tcfg, tparams,
                     torch.zeros((1, tcfg.max_seq_len + 1), dtype=torch.long))


def test_gpt_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default; the exact GELU is another function."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    _close(got.numpy(), want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(exact.numpy() - want).max() > 1e-4


# ---------------------------------------------------------------------------
# trainers against JaxTrainer
# ---------------------------------------------------------------------------

def _mlm_batch(b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    targets = rng.integers(4, VOCAB, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.3
    lengths = rng.integers(s // 2, s + 1, b)
    attn = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"tokens": np.where(mask, 3, targets).astype(np.int32),
            "targets": targets, "loss_mask": (mask & (attn > 0)),
            "attention_mask": attn}


def _mlm(module):
    def loss_fn(model_cfg, params, batch):
        return module.mlm_loss(model_cfg, params, batch["tokens"],
                               batch["targets"],
                               attention_mask=batch["attention_mask"],
                               loss_mask=batch["loss_mask"])
    return loss_fn


def _trainers(family):
    """JaxTrainer on a one-axis mesh of JAX's 8 CPU devices (batch 8) and
    a function making the port's Trainer (``b2`` settable) with a state
    from the same weights, same TrainConfig: gpt through the default
    next-token loss, bert through an mlm_loss hook over a padded batch."""
    jcfg, tcfg = _tiny(family)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
    if family == "gpt":
        batch = _tokens((8, 33), seed=5)
        jbatch, jloss_fn, tloss_fn = jnp.asarray(batch), None, None
    else:
        batch = _mlm_batch(seed=5)
        jbatch = jax.tree.map(jnp.asarray, batch)
        jloss_fn, tloss_fn = _mlm(jbert), _mlm(tbert)
    jt = JaxTrainer(jcfg, JaxTrainConfig(strategy="dp", **kw),
                    mesh=create_mesh({"dp": 8}), loss_fn=jloss_fn)
    jstate = jt.init_state(jax.random.key(0))
    start = jax.tree.map(lambda a: np.array(a, copy=True), jstate.params)

    def port(**port_kw):
        trainer = Trainer(tcfg, TrainConfig(**kw, **port_kw), device="cpu",
                          loss_fn=tloss_fn)
        return trainer, TrainState.create(_port(tcfg, start),
                                          trainer.optimizer)
    return jt, jstate, jbatch, port, batch, start


def _thirds(a):
    """The q, k and v thirds of a fused qkv bias [..., 3 * heads * hd]."""
    d = a.shape[-1] // 3
    return a[..., :d], a[..., d:2 * d], a[..., 2 * d:]


def _five_steps(step, state, batch):
    """5 steps of ``step``; the state and the losses and grad norms."""
    losses, norms = [], []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _param_errors(jstate, state) -> dict:
    """The largest difference of every leaf after the steps, the qkv bias
    by thirds (``blocks.bqkv.q``, ``.k``, ``.v``)."""
    final = dict(_named(jax.tree.map(np.asarray, jstate.params)))
    errs = {}
    for name, got in _named(state.params):
        diff = np.abs(got.detach().numpy() - final[name])
        if name == "blocks.bqkv":
            for part, d in zip("qkv", _thirds(diff)):
                errs[f"{name}.{part}"] = float(d.max())
        else:
            errs[name] = float(diff.max())
    return errs


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_trainer_matches_jax_trainer(family):
    """5 steps of losses and grad norms, then the final parameters,
    against JaxTrainer on a one-axis mesh of JAX's 8 CPU devices (batch
    8), same TrainConfig: gpt through the default next-token loss, bert
    through an mlm_loss hook over a padded batch.

    The key third of the fused qkv bias is held otherwise. The key bias
    adds q.b_k to every score of a row: a constant per row, which softmax
    ignores. So its true gradient is exactly zero (in gpt's causal and
    bert's padded attention alike), and what both frameworks compute
    there is rounding noise. Adam divides that noise by its own root mean
    square, so each step moves b_k by about the learning rate in a
    direction the noise sets, and the two runs part by up to lr * steps
    there. The test holds both frameworks' gradients of that third to
    rounding noise (under 1e-6 of the q third's gradient norm) and its
    travel to Adam's largest step, lr * steps; the q and v thirds and
    every other leaf stay at 2e-4 absolute. An optimizer with the wrong
    b2 (0.999, optax's default) must break that bound."""
    jt, jstate, jbatch, port, batch, start = _trainers(family)
    trainer, state = port()
    jgrad = np.asarray(jax.jit(jax.grad(jt._loss_fn))(
        jstate.params, jbatch)["blocks"]["bqkv"])
    _, tgrads = trainer.loss_and_grads(state.params, batch)
    for g in (jgrad, tgrads["blocks"]["bqkv"].numpy()):
        q, k, _ = _thirds(g)
        assert np.linalg.norm(k) < 1e-6 * np.linalg.norm(q)
    jstate, jl, jn = _five_steps(jt.train_step, jstate, jbatch)
    state, tl, tn = _five_steps(trainer.train_step, state, batch)
    assert state.step == int(jstate.step) == 5
    _close(tl, jl, rtol=1e-4, atol=0, msg="losses")
    _close(tn, jn, rtol=1e-4, atol=0, msg="grad norms")
    assert tl[-1] < tl[0]
    errs = _param_errors(jstate, state)
    held = {n: e for n, e in errs.items() if n != "blocks.bqkv.k"}
    assert max(held.values()) <= 2e-4, held
    lr_steps = trainer.cfg.learning_rate * 5
    k0 = _thirds(start["blocks"]["bqkv"])[1]
    for p in (state.params["blocks"]["bqkv"].detach().numpy(),
              np.asarray(jstate.params["blocks"]["bqkv"])):
        assert np.abs(_thirds(p)[1] - k0).max() <= lr_steps
    # control: the port with the wrong b2 breaks the bound on the other
    # leaves against the same JAX run
    trainer, state = port(b2=0.999)
    state, _, _ = _five_steps(trainer.train_step, state, batch)
    errs = _param_errors(jstate, state)
    assert max(e for n, e in errs.items() if n != "blocks.bqkv.k") > 2e-4


def test_trainer_init_state_uses_the_family():
    _, tcfg = _tiny("gpt")
    trainer = Trainer(tcfg, TrainConfig(learning_rate=1e-3, warmup_steps=1),
                      device="cpu")
    state = trainer.init_state(seed=0)
    assert "pos_embedding" in state.params
    batch = _tokens((2, 17), seed=6)
    losses = [float(trainer.train_step(state, batch)[1]["loss"])
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("family,kw,error", [
    ("mixtral", {}, TypeError),
    ("vit", {}, TypeError),
    ("gpt", {"fused_loss": True}, ValueError),
    ("bert", {}, ValueError),     # no forward and no loss_fn
])
def test_trainer_refuses_what_jax_refuses(family, kw, error):
    jcfg, tcfg = _tiny(family)
    with pytest.raises(error):
        JaxTrainer(jcfg, JaxTrainConfig(strategy="dp", **kw),
                   mesh=create_mesh({"dp": 8}))
    with pytest.raises(error):
        Trainer(tcfg, TrainConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_bert_encode_matches_jax(padded):
    """With a padding mask (pad tokens are segment 0 and attend to each
    other, as in JAX) and token types."""
    jcfg, jparams, tcfg, tparams = _pair("bert")
    b = _mlm_batch(b=3, s=20, seed=7)
    types = (np.arange(20)[None, :] >= 10).repeat(3, 0).astype(np.int32)
    mask = b["attention_mask"] if padded else None
    want = jax.jit(lambda p, t, m, ty: jbert.encode(
        jcfg, p, t, attention_mask=m, token_type_ids=ty))(
            jparams, jnp.asarray(b["tokens"]),
            None if mask is None else jnp.asarray(mask), jnp.asarray(types))
    got = tbert.encode(tcfg, tparams, torch.from_numpy(b["tokens"]).long(),
                       attention_mask=None if mask is None
                       else torch.from_numpy(mask),
                       token_type_ids=torch.from_numpy(types).long())
    _close(got.numpy(), want)


def test_bert_mlm_loss_and_grads_match_jax():
    jcfg, jparams, tcfg, tparams = _pair("bert", remat="full")
    b = _mlm_batch(b=4, s=16, seed=8)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _mlm(jbert)(jcfg, p, jax.tree.map(jnp.asarray, b))))(
            jparams)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = _mlm(tbert)(tcfg, _requires_grad(tparams), tb)
    _close(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(_grad_tree(loss, tparams), jgrads)


def test_bert_rejects_overlong_sequence():
    _, _, tcfg, tparams = _pair("bert")
    with pytest.raises(ValueError, match="max_seq_len"):
        tbert.encode(tcfg, tparams,
                     torch.zeros((1, tcfg.max_seq_len + 1), dtype=torch.long))


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def _images(b=3, seed=9, size=32):
    return np.random.default_rng(seed).random((b, size, size, 3)) \
        .astype(np.float32)


def test_vit_patchify_is_exact():
    jcfg, tcfg = _tiny("vit")
    x = _images()
    np.testing.assert_array_equal(
        tvit.patchify(tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jvit.patchify(jcfg, jnp.asarray(x))))
    with pytest.raises(ValueError, match="images"):
        tvit.patchify(tcfg, torch.zeros((1, 16, 16, 3)))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_forward_matches_jax(pool):
    jcfg, jparams, tcfg, tparams = _pair("vit", pool=pool)
    x = _images()
    want = jax.jit(lambda p, im: jvit.forward(jcfg, p, im))(
        jparams, jnp.asarray(x))
    got = tvit.forward(tcfg, tparams, torch.from_numpy(x))
    assert got.shape == (3, tcfg.n_classes) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_vit_gradient_matches_jax():
    """One softmax cross-entropy gradient, as the JAX package's one-step
    image test takes it."""
    jcfg, jparams, tcfg, tparams = _pair("vit")
    x = _images(b=4, seed=10)
    labels = np.array([1, 7, 3, 0], np.int32)

    def jloss(p):
        logits = jvit.forward(jcfg, p, jnp.asarray(x))
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                             jnp.asarray(labels)[:, None], 1))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    logits = tvit.forward(tcfg, _requires_grad(tparams), torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long())
    _close(float(loss.detach()), float(jl), rtol=1e-5)
    _grads_close(_grad_tree(loss, tparams), jgrads)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_entry_points_default_to_cuda(family):
    """With no card, init_params asked for nothing raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    _, tcfg = _tiny(family)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FAMILIES[family][1].init_params(tcfg)


def test_llama_init_draws_are_unchanged_by_the_shared_init():
    """llama.init_params goes through the shared ParamInit: one draw per
    stacked layer matrix, one for each unstacked matrix, in the old order."""
    cfg = tllama.llama_tiny()
    params = tllama.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) \
        * cfg.d_model ** -0.5
    wq0 = torch.randn((cfg.d_model, cfg.n_heads * cfg.head_dim),
                      generator=gen) * cfg.d_model ** -0.5
    assert torch.equal(params["embedding"], emb.to(cfg.param_dtype))
    assert torch.equal(params["blocks"]["wq"][0], wq0.to(cfg.param_dtype))
