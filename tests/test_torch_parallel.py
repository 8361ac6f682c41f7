"""The port's mesh, collectives and sharding rules against
ray_tpu.parallel, on the CPU.

The device-plane collectives run on rank lists (the port is
single-controller) and are held to JAX's ``shard_map`` results on the
8-device CPU platform: the same numpy input, cut the same way, must give
the same per-rank values (float32 sums of small integers: exact). The
sharding presets must give the partition specs JAX gives for the same
logical tuples and mesh shapes. The host plane runs among threads.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.parallel import collectives as jcol
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.sharding import PRESETS as JAX_PRESETS
from ray_tpu.parallel.sharding import \
    logical_sharding as jax_logical_sharding
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, Mesh, MeshRegistry,
                                         MeshSpec, create_hybrid_mesh,
                                         create_mesh, mesh_registry,
                                         slice_topology)
from ray_tpu_torch.parallel.sharding import (FSDP_TP_RULES, PRESETS, Axes,
                                             NamedSharding, PartitionSpec,
                                             ShardingRules, is_axes_leaf,
                                             logical_sharding)

CPU = torch.device("cpu")

# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_mesh_spec_wildcard():
    assert MeshSpec({"dp": -1, "tp": 2}).resolved(8) == {"dp": 4, "tp": 2}
    assert MeshSpec({"fsdp": 8}).resolved(8) == {"fsdp": 8}
    with pytest.raises(ValueError, match="require 6 devices, have 8"):
        MeshSpec({"dp": 3, "tp": 2}).resolved(8)
    with pytest.raises(ValueError, match="At most one axis"):
        MeshSpec({"dp": -1, "tp": -1}).resolved(8)
    with pytest.raises(ValueError, match="not divisible"):
        MeshSpec({"dp": -1, "tp": 3}).resolved(8)


def test_mesh_axis_canonical_order():
    resolved = MeshSpec({"tp": 2, "dp": 2, "fsdp": 2}).resolved(8)
    assert list(resolved) == ["dp", "fsdp", "tp"]
    # unknown axes go last, in the given order
    resolved = MeshSpec({"x": 2, "sp": 2, "pp": 2}).resolved(8)
    assert list(resolved) == ["pp", "sp", "x"]
    assert AXIS_ORDER == ("pp", "dp", "fsdp", "ep", "sp", "tp")


@pytest.mark.parametrize("axes", [{"dp": -1, "tp": 2}, {"tp": 2, "dp": 4},
                                  {"sp": 8}, {"x": 2, "fsdp": -1}])
def test_mesh_spec_resolves_as_jax(axes):
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    want = JaxMeshSpec(dict(axes)).resolved(8)
    got = MeshSpec(dict(axes)).resolved(8)
    assert list(got.items()) == list(want.items())


def test_create_mesh_with_repeated_devices():
    """One device may fill every place: a ring of four on one card."""
    mesh = create_mesh({"sp": 4}, devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("sp",) and mesh.shape == {"sp": 4}
    assert mesh.axis_devices("sp") == [CPU] * 4
    mesh = create_mesh({"tp": 2, "dp": 2, "sp": 2}, devices=[CPU] * 8)
    assert mesh.axis_names == ("dp", "sp", "tp")
    assert mesh.devices.shape == (2, 2, 2) and mesh.size == 8
    with pytest.raises(ValueError, match="require 4 devices, have 1"):
        create_mesh({"sp": 4}, devices=[CPU])


def test_axis_devices_follow_row_major_assignment():
    """Devices take JAX's row-major places off a TPU (device i is the
    i-th given; naming CUDA devices starts no CUDA)."""
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = create_mesh({"sp": 4, "dp": 2}, devices=devs)
    jmesh = jax_create_mesh({"sp": 4, "dp": 2})
    assert mesh.axis_names == jmesh.axis_names == ("dp", "sp")
    got = np.vectorize(lambda d: d.index)(mesh.devices)
    np.testing.assert_array_equal(got,
                                  np.vectorize(lambda d: d.id)(jmesh.devices))
    assert mesh.axis_devices("sp", {"dp": 1}) == devs[4:]
    assert mesh.axis_devices("dp", {"sp": 3}) == [devs[3], devs[7]]
    assert mesh.axis_devices("sp") == devs[:4]


def test_hybrid_mesh():
    mesh = create_hybrid_mesh({"tp": 4}, {"dp": 2}, devices=[CPU] * 8)
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.devices.shape == (2, 4)
    with pytest.raises(ValueError, match="not divisible by dcn axes"):
        create_hybrid_mesh({"tp": 4}, {"dp": 3}, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="no devices"):
        create_hybrid_mesh({"tp": 1}, {"dp": 1}, devices=[])


def test_mesh_registry():
    reg = mesh_registry()
    m = reg.get_or_create("test_torch_mesh", {"dp": -1}, devices=[CPU] * 2)
    assert reg.get("test_torch_mesh") is m
    assert reg.get_or_create("test_torch_mesh", {"dp": 1}) is m
    assert "test_torch_mesh" in reg.names()
    with pytest.raises(ValueError):
        reg.register("test_torch_mesh", m)
    reg.register("test_torch_mesh", m, overwrite=True)
    reg.remove("test_torch_mesh")
    with pytest.raises(KeyError):
        reg.get("test_torch_mesh")


def test_mesh_registry_concurrent_creators_get_one_mesh():
    reg = MeshRegistry()
    got = []

    def create():
        got.append(reg.get_or_create("m", {"sp": 2}, devices=[CPU] * 2))

    threads = [threading.Thread(target=create) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(m is got[0] for m in got)


def test_slice_topology_reports_the_cards():
    info = slice_topology()
    assert info["num_devices"] == torch.cuda.device_count()
    if info["num_devices"] == 0:
        assert info == {"platform": "none", "num_devices": 0,
                        "num_hosts": 0}
    else:
        assert info["platform"] == "cuda"
        assert len(info["device_kind"]) == info["num_devices"]


def test_default_devices_are_the_visible_cards():
    n = torch.cuda.device_count()
    if n:
        pytest.skip("this host has a card")
    with pytest.raises(ValueError, match="require 2 devices, have 0"):
        create_mesh({"sp": 2})


# ---------------------------------------------------------------------------
# device-plane collectives, against shard_map
# ---------------------------------------------------------------------------

def _jax_shard_map(fn, axis, n, x, in_spec, out_spec):
    mesh = jax_create_mesh({axis: n}, devices=jax.devices()[:n])
    return np.asarray(jax.shard_map(fn, mesh=mesh, in_specs=in_spec,
                                out_specs=out_spec)(jnp.asarray(x)))


def _ranks(x, n, dim=0):
    return col.shard(torch.from_numpy(x), [CPU] * n, dim)


def test_psum_matches_shard_map():
    x = np.arange(8.0, dtype=np.float32)
    want = _jax_shard_map(lambda v: jcol.psum(v, "dp"), "dp", 8, x,
                          JP("dp"), JP("dp"))
    got = col.unshard(col.psum(_ranks(x, 8)), 0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [1, 3, -1])
def test_ring_shift_matches_shard_map(shift):
    x = np.arange(8.0, dtype=np.float32)
    want = _jax_shard_map(lambda v: jcol.ring_shift(v, "sp", shift=shift),
                          "sp", 8, x, JP("sp"), JP("sp"))
    got = col.unshard(col.ring_shift(_ranks(x, 8), shift=shift), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.roll(x, shift))


@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1)])
def test_all_to_all_matches_shard_map(split, concat):
    x = np.arange(128.0, dtype=np.float32).reshape(16, 8)
    want = _jax_shard_map(
        lambda v: jcol.all_to_all(v, "ep", split_axis=split,
                                  concat_axis=concat),
        "ep", 4, x, JP("ep", None), JP("ep", None))
    got = col.unshard(col.all_to_all(_ranks(x, 4), split_axis=split,
                                     concat_axis=concat), 0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["pmean", "pmax", "all_gather",
                                  "reduce_scatter", "ppermute"])
def test_other_collectives_match_shard_map(name):
    x = np.random.default_rng(0).integers(-9, 9, (16, 8)).astype(np.float32)
    perm = [(0, 2), (1, 0), (2, 3)]          # rank 1 receives nothing
    fns = {
        "pmean": (lambda v: jcol.pmean(v, "dp"), col.pmean),
        "pmax": (lambda v: jcol.pmax(v, "dp"), col.pmax),
        "all_gather": (lambda v: jcol.all_gather(v, "dp"), col.all_gather),
        "reduce_scatter": (lambda v: jcol.reduce_scatter(v, "dp"),
                           col.reduce_scatter),
        "ppermute": (lambda v: jcol.ppermute(v, "dp", perm),
                     lambda xs: col.ppermute(xs, perm)),
    }
    jfn, tfn = fns[name]
    want = _jax_shard_map(jfn, "dp", 4, x, JP("dp", None), JP("dp", None))
    got = col.unshard(tfn(_ranks(x, 4)), 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_untiled_gather_and_scatter_and_axis_queries():
    xs = _ranks(np.arange(8.0, dtype=np.float32).reshape(4, 2), 4)
    stacked = col.all_gather(xs, tiled=False)
    assert stacked[2].shape == (4, 1, 2)
    parts = col.reduce_scatter([torch.ones(4, 3)] * 4, tiled=False)
    assert [p.shape for p in parts] == [(3,)] * 4
    assert torch.equal(parts[0], torch.full((3,), 4.0))
    assert col.axis_size(xs) == 4 and col.axis_index(xs) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        col.shard(torch.zeros(6), [CPU] * 4, 0)


def test_collectives_are_differentiable():
    x = torch.arange(8.0, requires_grad=True)
    out = col.unshard(col.ring_shift(col.psum(col.shard(x, [CPU] * 4, 0))),
                      0)
    (out * torch.arange(8.0)).sum().backward()
    # every rank's psum result reaches every input element of its slot
    want = torch.arange(8.0).reshape(4, 2).sum(0).repeat(4)
    assert torch.equal(x.grad, want)


# ---------------------------------------------------------------------------
# host plane, among threads
# ---------------------------------------------------------------------------

def _run_ranks(world, fn):
    results, errors = [None] * world, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


@pytest.fixture
def group():
    name = f"g{threading.get_ident()}"
    yield name
    col.destroy_collective_group(name)


def test_host_allreduce_ops(group):
    world = 4

    def body(rank):
        col.init_collective_group(world, rank, group_name=group)
        x = np.array([rank + 1.0, -rank], dtype=np.float32)
        return {op: col.allreduce(x, rank, group_name=group, op=op)
                for op in (col.ReduceOp.SUM, col.ReduceOp.PRODUCT,
                           col.ReduceOp.MAX, col.ReduceOp.MIN)}

    for res in _run_ranks(world, body):
        np.testing.assert_allclose(res["sum"], [10.0, -6.0])
        np.testing.assert_allclose(res["product"], [24.0, 0.0])
        np.testing.assert_allclose(res["max"], [4.0, 0.0])
        np.testing.assert_allclose(res["min"], [1.0, -3.0])


def test_host_allgather_broadcast_reducescatter_barrier(group):
    world = 3

    def body(rank):
        col.init_collective_group(world, rank, group_name=group)
        t = torch.full((2,), float(rank))
        gathered = col.allgather(t, rank, group_name=group)
        bcast = col.broadcast(np.array([rank * 10]), rank, src_rank=2,
                              group_name=group)
        rs = col.reducescatter(np.arange(6.0) * (rank + 1), rank,
                               group_name=group)
        col.barrier(rank, group_name=group)
        return gathered, bcast, rs

    for rank, (gathered, bcast, rs) in enumerate(_run_ranks(world, body)):
        assert all(isinstance(g, torch.Tensor) for g in gathered)
        assert [float(g[0]) for g in gathered] == [0.0, 1.0, 2.0]
        np.testing.assert_array_equal(bcast, [20])
        np.testing.assert_allclose(rs, (np.arange(6.0) * 6)[2 * rank:
                                                           2 * rank + 2])


def test_host_back_to_back_collectives_do_not_crosstalk(group):
    """Ranks race through 50 allreduces each; the epoch of each call keeps
    a fast rank's next contribution out of the current one."""
    world, rounds = 4, 50

    def body(rank):
        col.init_collective_group(world, rank, group_name=group)
        return [float(col.allreduce(np.array(i * 100.0 + rank), rank,
                                    group_name=group)) for i in range(rounds)]

    want = [i * 100.0 * world + sum(range(world)) for i in range(rounds)]
    for res in _run_ranks(world, body):
        assert res == want


def test_host_results_are_private_copies(group):
    def body(rank):
        col.init_collective_group(2, rank, group_name=group)
        out = col.allreduce(np.ones(3), rank, group_name=group)
        out += rank * 100          # in place on this rank's buffer only
        col.barrier(rank, group_name=group)
        return out

    a, b = _run_ranks(2, body)
    np.testing.assert_array_equal(a, [2.0] * 3)
    np.testing.assert_array_equal(b, [102.0] * 3)


def test_host_timeout_rolls_back_the_epoch(group):
    """A rank that times out withdraws; its retry joins the same epoch as
    the late rank."""
    col.init_collective_group(2, 0, group_name=group)
    mgr = col.group_manager()
    combine = lambda bucket: sum(bucket.values())  # noqa: E731
    with pytest.raises(TimeoutError):
        mgr._rendezvous(group, 0, "k", 1.0, combine, timeout=0.05)
    res = _run_ranks(2, lambda rank: mgr._rendezvous(group, rank, "k",
                                                     1.0 + rank, combine))
    assert res == [3.0, 3.0]


def test_host_plane_refuses_card_tensors_and_unknown_groups():
    with pytest.raises(KeyError):
        col.allreduce(np.ones(2), 0, group_name="no-such-group")
    with pytest.raises(ValueError, match="CPU tensors"):
        col._host_array(torch.empty(2, device="meta"))


# ---------------------------------------------------------------------------
# sharding rules, against JAX's presets
# ---------------------------------------------------------------------------

_LOGICAL = [("batch", "seq", "embed"), ("embed", "mlp"), ("mlp", "embed"),
            ("vocab", "embed"), ("layers", "embed", "heads"),
            ("expert", "embed", "mlp"), ("batch", None), ("embed", "embed"),
            ("kv_heads", "stage"), ()]
_MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 8}, {"fsdp": 2, "sp": 4},
           {"pp": 2, "fsdp": 2, "tp": 2}, {"ep": 4, "tp": 2}]


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


@pytest.mark.parametrize("preset", list(JAX_PRESETS))
def test_preset_specs_equal_jax(preset):
    assert list(PRESETS) == list(JAX_PRESETS)
    for axes in _MESHES:
        jmesh = jax_create_mesh(axes)
        mesh = create_mesh(axes, devices=[CPU] * 8)
        for logical in _LOGICAL:
            want = jax_logical_sharding(logical, jmesh,
                                        JAX_PRESETS[preset]).spec
            got = logical_sharding(logical, mesh, PRESETS[preset])
            assert isinstance(got, NamedSharding) and got.mesh is mesh
            assert isinstance(got.spec, PartitionSpec)
            assert _entries(got.spec) == _entries(want), (preset, axes,
                                                          logical)


def test_rules_filtered_for_small_mesh():
    mesh = create_mesh({"dp": 8}, devices=[CPU] * 8)
    assert logical_sharding(("embed", "mlp"), mesh, FSDP_TP_RULES).spec == \
        PartitionSpec(None, None)
    mesh = create_mesh({"dp": 2, "fsdp": 2, "tp": 2}, devices=[CPU] * 8)
    assert logical_sharding(("embed", "mlp"), mesh, FSDP_TP_RULES).spec == \
        PartitionSpec("fsdp", "tp")
    assert logical_sharding(("batch", None), mesh, FSDP_TP_RULES).spec == \
        PartitionSpec(("dp", "fsdp"), None)


def test_rules_helpers():
    rules = ShardingRules().with_overrides(seq="sp", mlp="tp")
    assert rules.seq == "sp" and rules.batch == ("dp", "fsdp")
    assert rules.mesh_axes(("seq", None, "mlp")) == \
        PartitionSpec("sp", None, "tp")
    assert PRESETS["fsdp_tp_sp"].seq == "sp"
    assert all(PRESETS[k].seq is None for k in PRESETS if k != "fsdp_tp_sp")
    assert is_axes_leaf(Axes(("embed", None)))
    assert is_axes_leaf(("embed", ("dp", "fsdp"), None))
    assert not is_axes_leaf(("embed", 3))
    from collections import namedtuple
    assert not is_axes_leaf(namedtuple("S", "a b")("x", "y"))
    assert repr(PartitionSpec("sp", None)) == "PartitionSpec('sp', None)"
    assert PartitionSpec(["dp", "fsdp"], ("tp",)) == (("dp", "fsdp"), "tp")
