"""The port's ``ray_tpu_torch.util`` against the JAX package's on the CPU:
the scenarios of ``tests/test_util.py`` (``ActorPool``, ``Queue`` and the
actor backend of the collectives), each run through ``ray_tpu`` and
``ray_tpu_torch`` on their in-process runtimes (started once for the
module), the results equal. Then what only the port has: torch tensors
into the collectives (a bf16 one promoted to float32, as JAX's numpy
bf16), placement groups and their strategy on the in-process runtime,
the lazy exports and the accelerator labels.
"""

import importlib
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def util(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.util.{name}")


def both(scenario) -> dict:
    return {name: scenario(pkg) for name, pkg in PACKAGES.items()}


class Squarer:
    def work(self, x):
        return x * x


class Sleeper:
    def work(self, x):
        time.sleep(0.01 * (5 - x))
        return x


def test_actor_pool_ordered_and_unordered(runtimes):
    def scenario(pkg):
        pool = util(pkg, "actor_pool").ActorPool(
            [pkg.remote(Squarer).remote() for _ in range(2)])
        ordered = list(pool.map(lambda a, v: a.work.remote(v), range(8)))
        pool = util(pkg, "actor_pool").ActorPool(
            [pkg.remote(Sleeper).remote() for _ in range(3)])
        unordered = list(pool.map_unordered(lambda a, v: a.work.remote(v),
                                            range(5)))
        return ordered, sorted(unordered)

    got = both(scenario)
    assert got["torch"] == got["jax"] == ([v * v for v in range(8)],
                                          list(range(5)))


def test_actor_pool_manual_management(runtimes):
    """submit/get_next/get_next_unordered/has_free/pop_idle/push, and a
    failing call that recycles its actor."""
    def scenario(pkg):
        mod = util(pkg, "actor_pool")
        a, b = (pkg.remote(Squarer).remote() for _ in range(2))
        pool = mod.ActorPool([a])
        out = [pool.has_free()]
        pool.submit(lambda act, v: act.work.remote(v), 3)
        pool.submit(lambda act, v: act.work.remote(v), 4)
        out += [pool.has_free(), pool.has_next(), pool.get_next(),
                pool.get_next_unordered(), pool.has_next()]
        pool.push(b)
        out.append(pool.pop_idle() is b)
        pool.submit(lambda act, v: act.work.remote(v), "x")   # str * str
        try:
            pool.get_next()
            out.append("no error")
        except Exception as e:  # noqa: BLE001 - the type is the result
            out.append(type(e).__name__)
        out.append(pool.has_free())
        try:
            pool.get_next()
        except StopIteration:
            out.append("StopIteration")
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"]
    assert got["jax"][:7] == [True, False, True, 9, 16, False, True]
    assert got["jax"][8:] == [True, "StopIteration"]


def test_queue_basic_full_empty_and_batches(runtimes):
    def scenario(pkg):
        mod = util(pkg, "queue")
        q = mod.Queue(maxsize=3)
        q.put(1)
        q.put(2)
        out = [q.qsize(), q.get(), q.get(), q.empty()]
        q1 = mod.Queue(maxsize=1)
        q1.put("a")
        try:
            q1.put("b", block=False)
        except mod.Full:
            out.append("Full")
        out.append(q1.get())
        try:
            q1.get(block=False)
        except mod.Empty:
            out.append("Empty")
        try:
            q1.get(timeout=0.05)
        except mod.Empty:
            out.append("Empty after timeout")
        q.put_nowait_batch([5, 6])
        try:
            q.put_nowait_batch([7, 8])
        except mod.Full:
            out.append("batch Full")
        out.append(q.get_nowait_batch(5))
        q.shutdown()
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        2, 1, 2, True, "Full", "a", "Empty", "Empty after timeout",
        "batch Full", [5, 6]]


def test_queue_cross_task(runtimes):
    def scenario(pkg):
        q = util(pkg, "queue").Queue()

        def producer(q, n):
            for i in range(n):
                q.put(i)
            return True

        ok = pkg.get(pkg.remote(producer).remote(q, 5))
        return ok, [q.get(timeout=10) for _ in range(5)]

    got = both(scenario)
    assert got["torch"] == got["jax"] == (True, list(range(5)))


def collective_scenario(pkg, group: str, inputs=None) -> list:
    """tests/test_util.py's four collective scenarios on the actor
    backend, each rank a task; ``inputs(rank)`` replaces the allreduce's
    numpy input."""
    col = util(pkg, "collective")
    inputs = inputs or (lambda rank: np.full(4, float(rank + 1)))

    def allreduce_fn(rank, world):
        g = col.init_collective_group(world, rank, f"{group}1")
        out = g.allreduce(inputs(rank))
        g.destroy()
        return out.dtype.str, out.tolist()

    def gather_bcast_fn(rank, world):
        g = col.init_collective_group(world, rank, f"{group}2")
        gathered = g.allgather(np.array([rank]))
        bcast = g.broadcast(np.array([rank * 10]), src_rank=1)
        return [int(a[0]) for a in gathered], int(bcast[0])

    def scatter_p2p_fn(rank, world):
        g = col.init_collective_group(world, rank, f"{group}3")
        shard = g.reducescatter(np.arange(4, dtype=np.float64))
        if rank == 0:
            g.send(np.array([42.0]), dst_rank=1)
            return shard.tolist(), None
        return shard.tolist(), g.recv(src_rank=0).tolist()

    def module_p2p_fn(rank, world):
        col.init_collective_group(world, rank, f"{group}4")
        if rank == 0:
            col.send(np.array([7.0, 8.0]), dst_rank=1,
                     group_name=f"{group}4")
            col.barrier(f"{group}4")
            return "sent"
        got = col.recv(src_rank=0, group_name=f"{group}4")
        col.barrier(f"{group}4")
        return got.tolist()

    out = []
    for fn, world in ((allreduce_fn, 3), (gather_bcast_fn, 2),
                      (scatter_p2p_fn, 2), (module_p2p_fn, 2)):
        task = pkg.remote(fn)
        out.append(pkg.get([task.remote(r, world) for r in range(world)],
                           timeout=60))
    return out


def test_collective_actor_backend(runtimes):
    got = both(lambda pkg: collective_scenario(pkg, "g"))
    assert got["torch"] == got["jax"]
    allreduce, gather_bcast, scatter_p2p, module_p2p = got["jax"]
    assert allreduce == [("<f8", [6.0] * 4)] * 3
    assert gather_bcast == [([0, 1], 10)] * 2
    assert scatter_p2p == [([0.0, 2.0], None), ([4.0, 6.0], [42.0])]
    assert module_p2p == ["sent", [7.0, 8.0]]


def test_collective_takes_torch_tensors(runtimes):
    """A torch tensor goes where JAX takes numpy: float32 as it is, bf16
    promoted to float32 (the float32 sum of the bf16 values), every
    result numpy; JAX on the same values as numpy float32."""
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(6, generator=gen).to(torch.bfloat16) for _ in range(3)]
    jax_out = collective_scenario(
        ray_tpu, "jt", lambda r: xs[r].float().numpy())[0]
    port_out = collective_scenario(ray_tpu_torch, "tt", lambda r: xs[r])[0]
    assert port_out == jax_out
    want = (xs[0].float() + xs[1].float() + xs[2].float()).tolist()
    assert jax_out[0] == ("<f4", want)


def test_placement_group_on_the_in_process_runtime(runtimes):
    """One node: a group is placed at once, its table empty, and its
    strategy accepted by a task (both packages) and by an actor (the
    port; JAX's refuses the option)."""
    def scenario(pkg):
        pgm = util(pkg, "placement_group")
        pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}])
        strategy = pgm.PlacementGroupSchedulingStrategy(pg, 1)
        out = [pg.ready(timeout=1), pgm.placement_group_table(pg),
               pg.bundle_specs, pg.strategy, strategy.bundle_index,
               pkg.get(pkg.remote(num_cpus=1, scheduling_strategy=strategy)(
                   lambda: "placed").remote())]
        try:
            actor = pkg.remote(Squarer).options(
                scheduling_strategy=strategy).remote()
            out.append(pkg.get(actor.work.remote(3)))
        except ValueError as e:
            out.append(type(e).__name__)
        pgm.remove_placement_group(pg)
        return out

    got = both(scenario)
    common = [True, {}, [{"CPU": 1}, {"CPU": 1}], "PACK", 1, "placed"]
    assert got["jax"] == common + ["ValueError"]
    assert got["torch"] == common + [9]


def test_lazy_exports_and_accelerator_labels():
    import ray_tpu.util as jutil
    import ray_tpu.util.accelerators as jacc

    import ray_tpu_torch.util as tutil
    from ray_tpu_torch.util import accelerators as tacc

    assert tutil.__all__ == jutil.__all__
    for name in tutil.__all__:
        assert getattr(tutil, name).__name__ == getattr(jutil, name).__name__
    with pytest.raises(AttributeError):
        tutil.NotAName  # noqa: B018
    assert tacc.ALL_TPU_TYPES == jacc.ALL_TPU_TYPES
    kinds = ["TPU v4", "TPU v5 lite", "TPU v5p", "TPU v6e", "TPU v6 lite",
             "TPU v2", "TPU v3", "cpu", "NVIDIA H100 80GB HBM3"]
    assert [tacc.tpu_generation_from_kind(k) for k in kinds] == \
        [jacc.tpu_generation_from_kind(k) for k in kinds]
    assert [tacc.gpu_generation_from_name(n) for n in (
        "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB", "NVIDIA L4",
        "NVIDIA L40S", "Tesla T4", "TPU v4")] == [
        tacc.NVIDIA_H100, tacc.NVIDIA_A100, tacc.NVIDIA_L4,
        tacc.NVIDIA_L40S, tacc.NVIDIA_TESLA_T4, None]
