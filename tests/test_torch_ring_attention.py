"""The port's sequence parallelism against ray_tpu's, on the CPU: ring
attention (both bodies), Ulysses, Llama's ring forward and the trainer's
ring path.

Every comparison feeds the same numpy inputs (and, for the models, the
same weights through ``convert.params_from_numpy``) to the JAX function
and the port's. JAX's flash ring runs its Pallas kernels in interpret
mode (``impl="flash"`` off a TPU, as JAX's own tests run it); the port's
flash ring runs the kernels' plain versions on the CPU. Chunks for the
flash body are 256 tokens at head_dim 64, the smallest the port's flash
gate takes. Everything is float32, where the two sides differ only in
summation order: outputs and gradients within 1e-4 relative and 1e-5
absolute (JAX's own ring tests allow 2e-3), the trainer as
``test_torch_train.py`` holds it (losses and gradient norms 1e-4
relative, parameters 2e-4 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.ring_attention import \
    ring_attention as jax_ring_attention
from ray_tpu.parallel.ulysses import \
    ulysses_attention_sharded as jax_ulysses_sharded
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.sharding import ShardingRules
from ray_tpu_torch.parallel.ulysses import (ulysses_attention,
                                            ulysses_attention_sharded)
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

RTOL, ATOL = 1e-4, 1e-5
VOCAB = 128


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (jax_create_mesh(axes, devices=jax.devices()[:n]),
            create_mesh(axes, devices=["cpu"] * n))


def _inputs(b, s, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


def _jax_out_and_grads(fn, q, k, v, g):
    """fn's output and the vjp of cotangent g in (q, k, v), jitted."""
    def both(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(jnp.asarray(g))
    out, grads = jax.jit(both)(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_out_and_grads(fn, q, k, v, g):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


# ---------------------------------------------------------------------------
# ring attention, against JAX's, both bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,axes,shape,causal", [
    # (b, s, h, hk, d)
    ("reference", {"sp": 4}, (2, 64, 4, 4, 16), True),
    ("reference", {"sp": 4}, (2, 64, 4, 4, 16), False),
    ("reference", {"sp": 4}, (1, 32, 8, 2, 16), True),          # GQA
    ("reference", {"dp": 2, "sp": 2}, (2, 64, 4, 2, 16), True),
    ("reference", {"sp": 2, "tp": 2}, (1, 64, 4, 2, 16), False),
    ("flash", {"sp": 4}, (1, 1024, 2, 2, 64), True),
    ("flash", {"sp": 4}, (1, 1024, 2, 2, 64), False),
    ("flash", {"sp": 2}, (1, 512, 4, 2, 64), True),             # GQA
    ("flash", {"dp": 2, "sp": 2}, (2, 512, 2, 1, 64), False),
])
def test_ring_matches_jax(impl, axes, shape, causal):
    """Output and the gradients of a random cotangent in q, k and v."""
    b, s, h, hk, d = shape
    q, k, v, g = _inputs(b, s, h, hk, d)
    jmesh, mesh = _meshes(axes)
    want, want_grads = _jax_out_and_grads(
        lambda q, k, v: jax_ring_attention(q, k, v, mesh=jmesh, axis="sp",
                                           causal=causal, impl=impl),
        q, k, v, g)
    got, grads = _port_out_and_grads(
        lambda q, k, v: ring_attention(q, k, v, mesh=mesh, axis="sp",
                                       causal=causal, impl=impl),
        q, k, v, g)
    _close(got, want, "out")
    for name, x, w in zip("qkv", grads, want_grads):
        _close(x, w, f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_whole_sequence_attention(causal):
    """The ring against the port's own attention over the whole sequence
    (top-left causal mask: the same as bottom right at sq == skv)."""
    q, k, v, _ = _inputs(1, 48, 4, 2, 16, seed=3)
    _, mesh = _meshes({"sp": 3})
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         mesh=mesh, causal=causal)
    want = reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("causal,launches", [(True, 10), (False, 16)])
def test_flash_ring_runs_the_kernel_once_per_live_step(causal, launches):
    """At sp 4 the forward runs K1 on the 4 diagonal steps and on the
    non-skipped off-diagonal ones: 10 causal, 16 not (``flash_fwd.calls``
    counts runs on either device; the card counts launches the same way in
    chip_smoke.py)."""
    q, k, v, _ = _inputs(1, 1024, 2, 1, 64, seed=4)
    _, mesh = _meshes({"sp": 4})
    before = fa.flash_fwd.calls
    with torch.no_grad():
        ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh,
                       causal=causal, impl="flash")
    assert fa.flash_fwd.calls - before == launches


def test_auto_takes_the_reference_body_on_the_cpu():
    q, k, v, _ = _inputs(1, 1024, 2, 1, 64, seed=5)
    _, mesh = _meshes({"sp": 4})
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = fa.flash_fwd.calls
    auto = ring_attention(*args, mesh=mesh)
    assert fa.flash_fwd.calls == before
    ref = ring_attention(*args, mesh=mesh, impl="reference")
    assert torch.equal(auto, ref)


def test_ring_rejects_indivisible_and_bad_arguments():
    _, mesh = _meshes({"sp": 4})
    q = torch.zeros(1, 30, 2, 16)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, q, q, mesh=mesh, axis="sp")
    with pytest.raises(ValueError, match="requires mesh"):
        ring_attention(q, q, q, mesh=None)
    q = torch.zeros(1, 32, 2, 16)
    with pytest.raises(ValueError, match="impl must be"):
        ring_attention(q, q, q, mesh=mesh, impl="pallas")


@pytest.mark.parametrize("shape", [(1, 512, 2, 2, 64),     # chunks of 128
                                   (1, 1152, 2, 2, 64),    # 288 % 128
                                   (1, 1024, 2, 2, 32)])   # head_dim 32
def test_flash_ring_refuses_a_chunk_the_kernels_do_not_take(shape):
    """Under impl="flash" such a chunk raises; it never goes quietly to
    the reference body."""
    b, s, h, hk, d = shape
    _, mesh = _meshes({"sp": 4})
    q, k, v, _ = _inputs(b, s, h, hk, d)
    before = fa.flash_fwd.calls
    with pytest.raises(ValueError, match="flash kernels take"):
        ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh=mesh,
                       impl="flash")
    assert fa.flash_fwd.calls == before


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(causal):
    """Output and gradients against JAX's ulysses_attention_sharded."""
    q, k, v, g = _inputs(2, 32, 8, 4, 16, seed=6)
    jmesh, mesh = _meshes({"sp": 4})
    want, want_grads = _jax_out_and_grads(
        lambda q, k, v: jax_ulysses_sharded(jmesh, q, k, v, causal=causal),
        q, k, v, g)
    got, grads = _port_out_and_grads(
        lambda q, k, v: ulysses_attention_sharded(mesh, q, k, v,
                                                  causal=causal),
        q, k, v, g)
    _close(got, want, "out")
    for name, x, w in zip("qkv", grads, want_grads):
        _close(x, w, f"d{name}")


def test_ulysses_head_divisibility_error():
    q = torch.zeros(1, 2, 6, 4)          # 6 heads, not divisible by sp 4
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention([q] * 4, [q] * 4, [q] * 4)
    kv = torch.zeros(1, 2, 2, 4)         # GQA: 2 kv heads below sp 4
    qq = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="k heads"):
        ulysses_attention([qq] * 4, [kv] * 4, [kv] * 4)


# ---------------------------------------------------------------------------
# Llama's ring path, and the trainer's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.llama_tiny(VOCAB), dtype="float32")
    tcfg = dataclasses.replace(tllama.llama_tiny(VOCAB), dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jparams


def _port_params(tcfg, jparams):
    return convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("axes", [{"sp": 4}, {"dp": 2, "sp": 2}])
def test_llama_ring_forward_matches_jax(tiny, axes):
    jcfg, tcfg, jparams = tiny
    jmesh, mesh = _meshes(axes)
    tokens = _tokens(2, 32, seed=7)
    want = jllama.forward(jcfg, jparams, jnp.asarray(tokens),
                          attn_impl="ring", mesh=jmesh)
    params = _port_params(tcfg, jparams)
    got = tllama.forward(tcfg, params, torch.from_numpy(tokens),
                         attn_impl="ring", mesh=mesh)
    _close(got.numpy(), np.asarray(want))
    # the ring changes no number of the whole-sequence forward
    plain = tllama.forward(tcfg, params, torch.from_numpy(tokens))
    _close(got.numpy(), plain.numpy())


def test_llama_ring_errors(tiny):
    """JAX's two errors: no mesh, and segment ids."""
    _, tcfg, jparams = tiny
    params = _port_params(tcfg, jparams)
    tokens = torch.from_numpy(_tokens(1, 16, seed=8))
    with pytest.raises(ValueError, match="requires mesh"):
        tllama.forward(tcfg, params, tokens, attn_impl="ring")
    _, mesh = _meshes({"sp": 2})
    with pytest.raises(ValueError, match="segment_ids"):
        tllama.forward(tcfg, params, tokens, attn_impl="ring", mesh=mesh,
                       segment_ids=torch.zeros_like(tokens))


def _named(tree, prefix=""):
    """(name, leaf) in JAX's leaf order (keys sorted, as jax.tree does)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("fused_loss", [False, True])
def test_trainer_ring_step_matches_jax_trainer(tiny, fused_loss):
    """Two steps on an sp-4 mesh under fsdp_tp_sp (the first at learning
    rate 0 under the warmup, the second at the peak) against JaxTrainer
    on JAX's sp-4 mesh: losses, gradient norms and every parameter after
    them."""
    jcfg, tcfg, _ = tiny
    kw = dict(mesh_axes={"sp": 4}, strategy="fsdp_tp_sp",
              learning_rate=1e-3, warmup_steps=1, total_steps=50,
              fused_loss=fused_loss, loss_chunk=16)
    jmesh, mesh = _meshes({"sp": 4})
    jt = JaxTrainer(jcfg, JaxTrainConfig(**kw), mesh=jmesh)
    assert jt.attn_impl == "ring"
    jstate = jt.init_state(jax.random.key(0))
    trainer = Trainer(tcfg, TrainConfig(**kw), mesh=mesh, device="cpu")
    assert trainer.attn_impl == "ring" and trainer.sp_axis == "sp"
    state = TrainState.create(_port_params(tcfg, jstate.params),
                              trainer.optimizer)
    batch = _tokens(2, 33, seed=9)
    for step in range(2):
        jstate, jm = jt.train_step(jstate, jnp.asarray(batch))
        state, tm = trainer.train_step(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad norm {step}")
    final = dict(_named(jax.tree.map(np.asarray, jstate.params)))
    for name, got in _named(state.params):
        np.testing.assert_allclose(got.detach().numpy(), final[name],
                                   rtol=0, atol=2e-4, err_msg=name)


def test_trainer_builds_the_ring_from_mesh_axes(tiny):
    """With no mesh, mesh_axes give one with every place on the trainer's
    device; rules given as ShardingRules work as a preset name does."""
    _, tcfg, jparams = tiny
    rules = ShardingRules(seq="sp")
    trainer = Trainer(tcfg, TrainConfig(mesh_axes={"sp": 4, "dp": -1},
                                        strategy=rules), device="cpu")
    assert trainer.rules is rules and trainer.attn_impl == "ring"
    assert trainer.mesh.shape == {"dp": 1, "sp": 4}
    state = TrainState.create(_port_params(tcfg, jparams), trainer.optimizer)
    state, m = trainer.train_step(state, _tokens(1, 17, seed=10))
    assert np.isfinite(float(m["loss"]))
    # a preset without a seq rule keeps whole-sequence attention
    plain = Trainer(tcfg, TrainConfig(mesh_axes={"sp": 1}, strategy="fsdp"),
                    device="cpu")
    assert plain.attn_impl == "auto" and plain.sp_axis == "sp"
    assert all(t.requires_grad for t in tree_leaves(state.params))


@pytest.mark.parametrize("kw,mesh_axes", [
    (dict(strategy="fsdp_tp_sp"), {"sp": 2, "tp": 2}),
    (dict(strategy="fsdp_tp_sp"), {"dp": 2, "sp": 2}),
    (dict(strategy="fsdp_tp_sp"), {"fsdp": 2, "sp": 2}),
    (dict(strategy="fsdp"), {"sp": 4}),             # no seq rule: sp is wide
    (dict(strategy="pp_fsdp"), {"pp": 2}),
    (dict(strategy="fsdp_tp_sp", n_microbatches=2), {"sp": 2}),
])
def test_other_wide_axes_still_raise(tiny, kw, mesh_axes):
    """The axes beside the ring that slice 6 refused (tp, dp and fsdp
    beside sp, an sp axis no rule cuts, a pipeline, microbatches) now
    train over the placed state: one step, from mesh_axes or from a
    given mesh, gives the loss and gradient norm of the one-place
    trainer on the same weights."""
    _, tcfg, jparams = tiny
    n = int(np.prod(list(mesh_axes.values())))
    batch = _tokens(2, 17, seed=11)
    one = Trainer(tcfg, TrainConfig(**kw), device="cpu", mesh=create_mesh(
        {"dp": 1}, devices=["cpu"]))
    _, want = one.train_step(TrainState.create(
        _port_params(tcfg, jparams), one.optimizer), batch)
    for trainer in (
            Trainer(tcfg, TrainConfig(mesh_axes=mesh_axes, **kw),
                    device="cpu"),
            Trainer(tcfg, TrainConfig(**kw), device="cpu",
                    mesh=create_mesh(mesh_axes, devices=["cpu"] * n))):
        state = TrainState.create(_port_params(tcfg, jparams),
                                  trainer.optimizer)
        _, got = trainer.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)


def test_ring_is_llama_only():
    cfg = tgpt.gpt_tiny()
    with pytest.raises(ValueError, match="llama-only"):
        Trainer(cfg, TrainConfig(mesh_axes={"sp": 2},
                                 strategy="fsdp_tp_sp"), device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        Trainer(cfg, TrainConfig(strategy="zero3"), device="cpu")
