"""The port's ``util.dask`` and ``util.spark`` against the JAX package's
on the CPU: the scenarios of ``tests/test_dask_on_ray.py`` (dask's graph
protocol is plain dicts and tuples, so ``ray_dask_get`` runs without
dask) through both packages' in-process runtimes (started once for the
module), results equal; and those of ``tests/test_spark_launcher.py``
(pyspark is not installed: the launch command, and the entry points'
``ImportError``), the port's command parsed by its own CLI.
"""

import importlib
import sys
from operator import add, mul

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def get(pkg):
    return importlib.import_module(f"{pkg.__name__}.util.dask").ray_dask_get


def both(scenario) -> dict:
    return {name: scenario(get(pkg)) for name, pkg in PACKAGES.items()}


def _make(i):
    return np.full((100,), i, dtype=np.float32)


def test_graphs(runtimes):
    """Simple graphs, keys nested in lists and structures, tuple keys with
    a shared upstream, inlined sub-tasks, aliases and literals, numpy
    blocks through the object plane."""
    def scenario(ray_dask_get):
        out = []
        dsk = {"x": 1, "y": (add, "x", 2), "z": (mul, "y", "y")}
        out += [ray_dask_get(dsk, "z"), ray_dask_get(dsk, ["z", "y", "x"])]
        dsk = {"a": 2, "b": (add, "a", 3), "c": (sum, ["a", "b", 10]),
               "d": (dict, [("k", "c")])}
        out += [ray_dask_get(dsk, "c"),
                ray_dask_get(dsk, [["c"], ["b", "a"]]),
                ray_dask_get(dsk, "d")]
        dsk = {("blk", i): (mul, i, 10) for i in range(4)}
        dsk["total"] = (sum, [("blk", i) for i in range(4)])
        out += [ray_dask_get(dsk, "total"), ray_dask_get(dsk, ("blk", 2))]
        out.append(ray_dask_get({"x": 5, "y": (add, (mul, "x", 2), 1)}, "y"))
        dsk = {"x": 7, "alias": "x", "lit": "not-a-key"}
        out += [ray_dask_get(dsk, "alias"), ray_dask_get(dsk, "lit")]
        dsk = {("p", i): (_make, i) for i in range(3)}
        dsk["stack"] = (np.stack, [("p", i) for i in range(3)])
        dsk["mean"] = (np.mean, "stack")
        out.append(float(ray_dask_get(dsk, "mean")))
        out.append(ray_dask_get({"x": 1, "y": (add, "x", 2)}, "y",
                                ray_remote_args={"num_cpus": 1}))
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        9, [9, 3, 1], 17, [[17], [5, 2]], {"k": 17}, 60, 20, 11, 7,
        "not-a-key", 1.0, 3]


def test_cycle_detection(runtimes):
    def scenario(ray_dask_get):
        with pytest.raises(ValueError, match="cycle"):
            ray_dask_get({"x": (add, "y", 1), "y": (add, "x", 1)}, "x")
        return True

    assert both(scenario) == {"jax": True, "torch": True}


def test_enable_dask_on_ray_requires_dask(monkeypatch):
    """With dask hidden (a None in ``sys.modules``), ``enable_dask_on_ray``
    raises an ImportError that names it, in both packages."""
    monkeypatch.setitem(sys.modules, "dask", None)
    for pkg in PACKAGES.values():
        mod = importlib.import_module(f"{pkg.__name__}.util.dask")
        with pytest.raises(ImportError, match="dask"):
            mod.enable_dask_on_ray()


def spark(pkg):
    return importlib.import_module(f"{pkg.__name__}.util.spark")


def test_spark_worker_start_cmd_protocol():
    from ray_tpu_torch.scripts import cli

    jcmd = spark(ray_tpu)._worker_start_cmd(("10.0.0.1", 6379), num_cpus=8,
                                            num_tpus=4)
    cmd = spark(ray_tpu_torch)._worker_start_cmd(("10.0.0.1", 6379),
                                                 num_cpus=8, num_gpus=4)
    # the same protocol on the port's own CLI and the GPU resource; JAX's
    # "--block" (a long-lived barrier task) is what the port's start
    # always does, and JAX's own start refuses the flag
    assert "--block" in jcmd
    assert cmd == [c.replace("ray_tpu.", "ray_tpu_torch.").replace(
        "--num-tpus", "--num-gpus") for c in jcmd if c != "--block"]
    assert cmd[0] == sys.executable
    assert "--address" in cmd and "10.0.0.1:6379" in cmd
    assert cmd[cmd.index("--num-cpus") + 1] == "8"
    assert cmd[cmd.index("--num-gpus") + 1] == "4"
    assert cmd[1:3] == ["-m", "ray_tpu_torch.scripts.cli"]
    args = cli.build_parser().parse_args(cmd[3:])
    assert (args.cmd, args.address, args.num_cpus, args.num_gpus,
            args.fn) == ("start", "10.0.0.1:6379", 8.0, 4.0, cli.cmd_start)


def test_spark_entry_points_require_pyspark(monkeypatch):
    """With pyspark hidden, both packages' entry points raise an
    ImportError that names it."""
    monkeypatch.setitem(sys.modules, "pyspark", None)
    for pkg in PACKAGES.values():
        mod = spark(pkg)
        assert mod.MAX_NUM_WORKER_NODES == -1
        with pytest.raises(ImportError, match="pyspark"):
            mod.setup_ray_cluster(num_worker_nodes=2)
        with pytest.raises(ImportError, match="pyspark"):
            mod.shutdown_ray_cluster()
