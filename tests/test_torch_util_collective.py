"""The port's host collectives (``ray_tpu_torch._private.tcp_collective``
over its copy of the C++ TCP ring, and ``util.collective``) against the
JAX package's on the CPU: the scenarios of ``tests/test_cpp_collective.py``
but its cluster one.

Each spawned world (2 and 3 ranks) runs, in every rank process, JAX's
``TcpGroup`` and then the port's on the same inputs: allreduce (sum and
max), a large and a tiny buffer, allgather, reducescatter (the ring's
equal chunks and the general split), broadcast, barrier and tagged
send/recv out of order; the two packages' results equal, and each
process loads each package's own library only. Then the groups through
each package's in-process runtime (started once for the module):
``backend="tcp"``, a re-initialized group of the same name, a timed-out
``recv`` and the actor backend's ``destroy``.
"""

import importlib
import multiprocessing as mp
import socket

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import shm_store as jstore
from ray_tpu_torch._private import build

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def libraries():
    """Both packages' libraries built before any spawn: the port's by
    ``_private/build.py``, JAX's by its store binding's ``make -C src``."""
    jstore.get_lib()
    return build.build("tcp_collective")


@pytest.fixture(scope="module")
def runtimes(libraries):
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _tcp_scenario(g, rank, world, bf16_input) -> dict:
    out = {"allreduce_f32": g.allreduce(
        np.full(1000, rank + 1, dtype=np.float32)).tolist()[:1]}
    out["allreduce_max_i64"] = g.allreduce(
        np.array([rank * 10], dtype=np.int64), op="max").tolist()
    big = g.allreduce(np.ones(1 << 20, dtype=np.float32))
    out["allreduce_big_ok"] = bool(np.all(big == world))
    out["allreduce_tiny"] = g.allreduce(
        np.array([1.0], dtype=np.float64)).tolist()
    rng = np.random.default_rng(rank)
    x = rng.standard_normal(999).astype(np.float32)
    red = g.allreduce(x, op="min")
    out["allreduce_min_bits"] = red.view(np.int32).tolist()
    bf = g.allreduce(bf16_input)
    out["allreduce_bf16"] = [bf.dtype.str, bf.view(np.int32).tolist()]
    out["allgather"] = [int(a[0]) for a in
                        g.allgather(np.array([rank], dtype=np.int32))]
    out["reducescatter"] = g.reducescatter(
        np.arange(world * 2, dtype=np.float64)).tolist()
    out["reducescatter_uneven"] = g.reducescatter(
        np.arange(7, dtype=np.int64) * (rank + 1)).tolist()
    out["broadcast"] = g.broadcast(
        np.array([rank], dtype=np.int32), src_rank=world - 1).tolist()
    g.barrier()
    if rank == 0:
        g.send(np.array([111.0]), 1, tag=1)
        g.send(np.arange(6, dtype=np.int64).reshape(2, 3), 1, tag=0)
    elif rank == 1:
        a = g.recv(0, tag=0)
        b = g.recv(0, tag=1)
        out["p2p"] = [a.dtype.str, a.tolist(), float(b[0])]
    g.destroy()
    return out


def _worker(rank, world, peers, q):
    """Runs in a spawned process: JAX's group on ``peers["jax"]``, then
    the port's on ``peers["torch"]``; the port's bf16 input a torch
    tensor, JAX's the same values as a numpy bf16 array."""
    try:
        import ml_dtypes
        import torch

        from ray_tpu._private import tcp_collective as jtc
        from ray_tpu_torch._private import tcp_collective as ttc

        t = (torch.arange(16, dtype=torch.float32) * 0.37 + rank) \
            .to(torch.bfloat16)
        inputs = {"jax": t.float().numpy().astype(ml_dtypes.bfloat16),
                  "torch": t}
        out = {}
        for name, mod in (("jax", jtc), ("torch", ttc)):
            g = mod.TcpGroup(rank, world, peers[name])
            out[name] = _tcp_scenario(g, rank, world, inputs[name])
        out["libraries"] = [jtc._lib._name, ttc._lib._name]
        q.put((rank, out))
    except Exception as e:  # noqa: BLE001 - surface a child's failure
        q.put((rank, {"error": repr(e)}))


@pytest.mark.parametrize("world", [2, 3])
def test_tcp_group_multiprocess(libraries, world):
    ports = _free_ports(2 * world)
    peers = {"jax": [f"127.0.0.1:{p}" for p in ports[:world]],
             "torch": [f"127.0.0.1:{p}" for p in ports[world:]]}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, peers, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, out = q.get(timeout=120)
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, out in results.items():
        assert "error" not in out, f"rank {rank}: {out['error']}"
    expect_sum = sum(r + 1 for r in range(world))
    for rank in range(world):
        jax_out, port_out = results[rank]["jax"], results[rank]["torch"]
        assert port_out == jax_out
        assert jax_out["allreduce_f32"] == [float(expect_sum)]
        assert jax_out["allreduce_max_i64"] == [(world - 1) * 10]
        assert jax_out["allreduce_big_ok"]
        assert jax_out["allreduce_tiny"] == [float(world)]
        assert jax_out["allreduce_bf16"][0] == "<f4"
        assert jax_out["allgather"] == list(range(world))
        assert jax_out["reducescatter"] == [world * 2.0 * rank,
                                            world * (2.0 * rank + 1)]
        want = np.array_split(np.arange(7) * sum(range(1, world + 1)),
                              world)[rank]
        assert jax_out["reducescatter_uneven"] == want.tolist()
        assert jax_out["broadcast"] == [world - 1]
        jax_lib, port_lib = results[rank]["libraries"]
        assert "ray_tpu/_private/libtpucollective" in jax_lib
        assert "ray_tpu_torch/_build/libtcp_collective-" in port_lib
    mins = np.min([np.random.default_rng(r).standard_normal(999).astype(
        np.float32) for r in range(world)], axis=0)
    assert results[0]["jax"]["allreduce_min_bits"] == \
        mins.view(np.int32).tolist()
    assert results[1]["jax"]["p2p"] == ["<i8", [[0, 1, 2], [3, 4, 5]],
                                        111.0]


def test_tcp_group_world_one(libraries):
    out = {}
    for name, pkg in PACKAGES.items():
        tc = importlib.import_module(f"{pkg.__name__}._private.tcp_collective")
        g = tc.TcpGroup(0, 1, ["127.0.0.1:0"])
        out[name] = [g.allreduce(np.array([3.0])).tolist(),
                     [a.tolist() for a in g.allgather(np.array([7]))]]
        g.barrier()
        g.destroy()
    assert out["torch"] == out["jax"] == [[3.0], [[7]]]


def col(pkg):
    return importlib.import_module(f"{pkg.__name__}.util.collective")


def both(scenario) -> dict:
    return {name: scenario(pkg) for name, pkg in PACKAGES.items()}


def test_collective_tcp_backend_through_runtime(runtimes):
    def scenario(pkg):
        def rank_fn(rank, world):
            g = col(pkg).init_collective_group(world, rank, "tcpg",
                                               backend="tcp")
            red = g.allreduce(np.full(8, float(rank + 1), dtype=np.float32))
            gat = g.allgather(np.array([rank], dtype=np.int64))
            scat = g.reducescatter(np.arange(6, dtype=np.float64))
            g.barrier()
            g.destroy()
            return red.tolist()[:1], [int(a[0]) for a in gat], scat.tolist()

        task = pkg.remote(rank_fn)
        return pkg.get([task.remote(r, 3) for r in range(3)], timeout=60)

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        ([6.0], [0, 1, 2], [0.0, 3.0]), ([6.0], [0, 1, 2], [6.0, 9.0]),
        ([6.0], [0, 1, 2], [12.0, 15.0])]


def test_tcp_group_reinit_same_name(runtimes):
    def scenario(pkg):
        def rank_fn(rank, world, value):
            g = col(pkg).init_collective_group(world, rank, "reinit",
                                               backend="tcp")
            out = g.allreduce(np.array([value], dtype=np.float64))
            g.destroy()
            return float(out[0])

        task = pkg.remote(rank_fn)
        return [pkg.get([task.remote(r, 2, v) for r in range(2)], timeout=60)
                for v in (1.0, 10.0)]

    got = both(scenario)
    assert got["torch"] == got["jax"] == [[2.0, 2.0], [20.0, 20.0]]


def test_tcp_recv_timeout_and_actor_backend_destroy(runtimes):
    def scenario(pkg):
        def timeout_fn(rank, world):
            g = col(pkg).init_collective_group(world, rank, "tmo",
                                               backend="tcp")
            if rank == 1:
                try:
                    g.recv(0, tag=7, timeout=0.5)   # nothing ever sent
                    return "no-timeout"
                except TimeoutError:
                    return "timeout"
                finally:
                    g.barrier()
                    g.destroy()
            g.barrier()
            g.destroy()
            return "sender-done"

        def destroy_fn(rank, world):
            g = col(pkg).init_collective_group(world, rank, "adg")
            out = g.allreduce(np.array([1.0]))
            g.destroy()
            return float(out[0])

        return [pkg.get([pkg.remote(fn).remote(r, 2) for r in range(2)],
                        timeout=60) for fn in (timeout_fn, destroy_fn)]

    got = both(scenario)
    assert got["torch"] == got["jax"] == [["sender-done", "timeout"],
                                          [2.0, 2.0]]
    with pytest.raises(ValueError, match="not initialized"):
        col(ray_tpu_torch).get_group("never-made")
