"""The port's placement of state over a mesh against ray_tpu's, on the CPU.

JAX places arrays on its 8 CPU devices; the port places tensors on a
mesh of the same shape whose eight places are all the CPU. For every
preset and every family the port's ``tree_shardings`` must give JAX's
specs, and every chunk of ``shard_tree`` must equal, element for
element, JAX's ``addressable_shards[i].data`` for the device at flat
position ``i`` of the mesh. Places holding one index range on one device
share one tensor (the same storage), so a placement costs the bytes of
the unplaced tree. Also: ``state_logical_axes``, the trainer's state
shardings and ``CheckpointManager.restore(shardings=)``.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmixtral
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.train.state import TrainState as JaxTrainState
from ray_tpu.train.state import state_logical_axes as jax_state_axes
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmixtral
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.train.state import TrainState, state_logical_axes
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

VOCAB = 128
MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"pp": 2, "fsdp": 2, "tp": 2},
          {"fsdp": 2, "ep": 2, "tp": 2}]
FAMILIES = {
    "llama": (jllama, tllama, "llama_tiny"),
    "mixtral": (jmixtral, tmixtral, "mixtral_tiny"),
    "gpt": (jgpt, tgpt, "gpt_tiny"),
    "bert": (jbert, tbert, "bert_tiny"),
    "vit": (jvit, tvit, "vit_tiny"),
}


def _configs(family):
    jmod, tmod, preset = FAMILIES[family]
    if family == "vit":
        return jmod.vit_tiny(), tmod.vit_tiny()
    return getattr(jmod, preset)(VOCAB), getattr(tmod, preset)(VOCAB)


def _meshes(axes):
    return (jax_create_mesh(axes),
            create_mesh(axes, devices=["cpu"] * 8))


def _named(tree, prefix=""):
    """(dotted name, leaf) of a nested dictionary."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _check_chunks(jarr, placed, jmesh, name=""):
    """Every chunk of ``placed`` equals JAX's shard on the device at its
    flat position; chunks that hold one index range are one tensor."""
    flat = list(jmesh.devices.ravel())
    assert len(placed.chunks) == len(flat)
    for shard in jarr.addressable_shards:
        i = flat.index(shard.device)
        np.testing.assert_array_equal(
            placed.chunks[i].detach().float().numpy(),
            np.asarray(shard.data, np.float32), err_msg=f"{name} place {i}")
    by_range = {}
    for idx, chunk in zip(placed.sharding.indices(placed.shape),
                          placed.chunks):
        key = tuple((s.start, s.stop) for s in idx)
        assert by_range.setdefault(key, chunk) is chunk, name


@pytest.mark.parametrize("preset", list(jsharding.PRESETS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tree_shardings_specs_equal_jax(family, preset):
    jmod, tmod, _ = FAMILIES[family]
    jcfg, tcfg = _configs(family)
    for axes in MESHES:
        jmesh, mesh = _meshes(axes)
        want = dict(_named(jsharding.tree_shardings(
            jmod.param_logical_axes(jcfg), jmesh,
            jsharding.PRESETS[preset]), ))
        got = dict(_named(sharding.tree_shardings(
            tmod.param_logical_axes(tcfg), mesh, sharding.PRESETS[preset])))
        assert set(got) == set(want)
        for name, s in got.items():
            assert isinstance(s, sharding.NamedSharding) and s.mesh is mesh
            assert _entries(s.spec) == _entries(want[name].spec), \
                (axes, name)


@pytest.fixture(scope="module")
def family_params():
    """family -> (JAX parameters, the port's copy), made once."""
    made = {}

    def get(family):
        if family not in made:
            jmod = FAMILIES[family][0]
            jcfg, tcfg = _configs(family)
            jparams = jmod.init_params(jcfg, jax.random.key(0))
            made[family] = (jparams, convert.params_from_numpy(
                tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
        return made[family]
    return get


@pytest.mark.parametrize("preset", list(jsharding.PRESETS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_shard_tree_chunks_equal_jax_shards(family, preset, family_params):
    """The family's JAX-initialized parameters placed by both packages:
    every chunk equals JAX's addressable shard."""
    jmod, tmod, _ = FAMILIES[family]
    jcfg, tcfg = _configs(family)
    jparams, params = family_params(family)
    for axes in MESHES:
        jmesh, mesh = _meshes(axes)
        jplaced = dict(_named(jsharding.shard_tree(
            jparams, jmod.param_logical_axes(jcfg), jmesh,
            jsharding.PRESETS[preset])))
        placed = dict(_named(sharding.shard_tree(
            params, tmod.param_logical_axes(tcfg), mesh,
            sharding.PRESETS[preset])))
        for name, st in placed.items():
            assert isinstance(st, sharding.ShardedTensor)
            _check_chunks(jplaced[name], st, jmesh, f"{axes} {name}")
            assert torch.equal(st.unshard(), dict(_named(params))[name])


def _storage_bytes(trees) -> int:
    """Bytes of the distinct storages the tensors of ``trees`` use."""
    seen = {}
    for t in trees:
        for c in (t.chunks if isinstance(t, sharding.ShardedTensor)
                  else [t]):
            st = c.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def test_replicated_places_share_storage():
    """Under fsdp_tp on {dp 2, fsdp 2, tp 2}: a leaf cut over fsdp and tp
    has 4 distinct chunks shared by the dp replicas, a norm (cut over
    fsdp only) 2; chunks are views of the placed tensor; the placed state
    takes the unplaced state's bytes. A placement that copies its
    replicas does not."""
    _, tcfg = _configs("llama")
    params = tllama.init_params(tcfg, seed=0, device="cpu")
    _, mesh = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    placed = sharding.shard_tree(params, tllama.param_logical_axes(tcfg),
                                 mesh, sharding.FSDP_TP_RULES)
    wq, norm = placed["blocks"]["wq"], placed["blocks"]["attn_norm"]
    assert len(wq.distinct()) == 4 and len(norm.distinct()) == 2
    assert wq.chunks[0] is wq.chunks[4]          # dp 0 and dp 1
    assert norm.chunks[0] is norm.chunks[1]      # tp 0 and tp 1
    base = params["blocks"]["wq"].untyped_storage().data_ptr()
    assert all(c.untyped_storage().data_ptr() == base for c in wq.chunks)
    leaves = tree_leaves(placed)
    assert _storage_bytes(leaves) == _storage_bytes(tree_leaves(params))
    copied = [sharding.ShardedTensor(st.shape, st.dtype, st.sharding,
                                     [c.clone() for c in st.chunks])
              for st in leaves]
    assert _storage_bytes(copied) > 2 * _storage_bytes(leaves)


def test_device_put_errors_take_and_shardings():
    _, mesh = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    with pytest.raises(ValueError, match="not divisible"):
        sharding.device_put(torch.zeros(3, 4), sharding.NamedSharding(
            mesh, sharding.P("fsdp")))
    with pytest.raises(ValueError, match="not on the mesh"):
        sharding.NamedSharding(mesh, sharding.P("pp"))
    assert sharding.replicated(mesh).spec == sharding.P()
    jmesh, _ = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    for ndim, seq in ((2, False), (3, True)):
        for preset in ("fsdp", "fsdp_tp_sp"):
            want = jsharding.batch_sharding(jmesh, jsharding.PRESETS[preset],
                                            ndim, shard_seq=seq).spec
            got = sharding.batch_sharding(mesh, sharding.PRESETS[preset],
                                          ndim, shard_seq=seq).spec
            assert _entries(got) == _entries(want)
    # take: the places of one pp index, as a tensor on the rest
    _, pmesh = _meshes({"pp": 2, "fsdp": 2, "tp": 2})
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    st = sharding.device_put(x, sharding.NamedSharding(
        pmesh, sharding.P("pp", "fsdp", "tp")))
    stage = st.take("pp", 1)
    assert stage.mesh.shape == {"fsdp": 2, "tp": 2}
    assert stage.spec == sharding.P(None, "fsdp", "tp")
    assert torch.equal(stage.unshard(), x[2:])
    assert stage.chunks[3] is st.chunks[7]


def test_state_logical_axes_match_jax():
    """Moments inherit their parameters' axes, the step count and step
    are replicated: as JAX's over its optax state."""
    jcfg, tcfg = _configs("llama")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    jstate = JaxTrainState.create(jparams, optax.adamw(1e-3))
    jaxes = jax_state_axes(jstate, jllama.param_logical_axes(jcfg))
    adam = jaxes.opt_state[0]
    params = tllama.init_params(tcfg, device="meta")
    tr = Trainer(tcfg, TrainConfig(), device="cpu")
    axes = state_logical_axes(TrainState.create(params, tr.optimizer),
                              tllama.param_logical_axes(tcfg))
    assert axes.step == () and axes.opt_state["count"] == ()
    assert adam.count == () and jaxes.step == ()
    for got, want in ((axes.params, jaxes.params),
                      (axes.opt_state["mu"], adam.mu),
                      (axes.opt_state["nu"], adam.nu)):
        got, want = dict(_named(got)), dict(_named(want))
        assert set(got) == set(want)
        for name, ax in got.items():
            assert isinstance(ax, sharding.Axes)
            assert tuple(ax) == tuple(want[name]), name


@pytest.mark.parametrize("axes,strategy", [
    ({"dp": 2, "fsdp": 2, "tp": 2}, "fsdp_tp"),
    ({"pp": 2, "fsdp": 2, "tp": 2}, "pp_fsdp"),
])
def test_trainer_state_shardings_match_jax(axes, strategy):
    """Trainer.state_shardings: JaxTrainer's specs for the parameters and
    both moments; abstract_state takes no memory."""
    jcfg, tcfg = _configs("llama")
    jmesh, mesh = _meshes(axes)
    jt = JaxTrainer(jcfg, JaxTrainConfig(strategy=strategy), mesh=jmesh)
    tr = Trainer(tcfg, TrainConfig(strategy=strategy), mesh=mesh,
                 device="cpu")
    assert all(t.is_meta for t in tree_leaves(tr.abstract_state().params))
    jsh, sh = jt.state_shardings(), tr.state_shardings()
    adam = jsh.opt_state[1][0]
    for got, want in ((sh.params, jsh.params),
                      (sh.opt_state["mu"], adam.mu),
                      (sh.opt_state["nu"], adam.nu)):
        want = dict(_named(want))
        for name, s in _named(got):
            assert _entries(s.spec) == _entries(want[name].spec), name
    assert sh.step.spec == sharding.P() == sh.opt_state["count"].spec


def test_restore_with_shardings_places_the_saved_state(tmp_path):
    """A placed state saved (global arrays, as Orbax writes) and restored
    with the trainer's state shardings: the same chunks, replicas
    sharing; the restored state trains on as the saved one does."""
    _, tcfg = _configs("llama")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    _, mesh = _meshes({"dp": 2, "fsdp": 2, "tp": 2})
    tr = Trainer(tcfg, TrainConfig(strategy="fsdp_tp", learning_rate=1e-3,
                                   warmup_steps=1), mesh=mesh, device="cpu")
    state = tr.init_state(seed=3)
    batch = np.random.default_rng(0).integers(0, VOCAB, (4, 17)).astype(
        np.int32)
    state, _ = tr.train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, state)
    plain = mgr.restore(1, device="cpu")
    for name, st in _named(state.params):
        assert torch.equal(dict(_named(plain.params))[name], st.unshard())
    restored = mgr.restore(1, target=tr.abstract_state(),
                           shardings=tr.state_shardings())
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for got, want in zip(tree_leaves(restored.params) +
                         tree_leaves(restored.opt_state["mu"]),
                         tree_leaves(state.params) +
                         tree_leaves(state.opt_state["mu"])):
        assert got.spec == want.spec
        for a, b in zip(got.chunks, want.chunks):
            assert torch.equal(a, b.detach())
        assert len(got.distinct()) == len(want.distinct())
    _, m1 = tr.train_step(state, batch)
    _, m2 = tr.train_step(restored, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    with pytest.raises(ValueError, match="target"):
        mgr.restore(1, target={"params": {}}, device="cpu")
    mgr.close()
