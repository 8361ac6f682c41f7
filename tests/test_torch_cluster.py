"""The port's cluster runtime against the JAX package's, on the CPU.

The scenarios of ``tests/test_cluster.py`` and ``tests/test_lease.py``
that need no fault injection run once on ``ray_tpu.cluster_utils.Cluster``
and once on ``ray_tpu_torch.cluster_utils.Cluster``, each started once for
the module (two nodes; its tasks in worker processes), and their results
must be equal: exact for values, error types and the orderings JAX
guarantees. Then what only the port has to show: torch tensors (float32,
bfloat16, int64, nested in a dict) through ``put``, arguments and returns
bit for bit, and a function of a driver's ``__main__`` reaching a worker
as ``__mp_main__`` without running the file's main block.

The tasks and actors live in ``tests/torch_cluster_tasks.py``. The port
carries them by stdlib pickle, by reference: its workers import that
module, as their raylet hands them the driver's ``sys.path``. The JAX
package's workers cannot import it, so its cloudpickle carries the module
by value. A task that calls the package's API takes the package's name. No check reads a
wall clock: JAX's ``test_parallel_tasks`` fails on its timing.
"""

import importlib
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch.cluster_utils import Cluster as TorchCluster

import torch_cluster_tasks
from torch_cluster_tasks import (Counter, NodeOf, Pinger, Registry, add,
                                 add_nested, boom, consume, describe, die,
                                 die_once, double, kv_read, node_of,
                                 passthrough, pid, produce, read_env,
                                 set_env, sleep_then, tensors_back)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("jax", "torch")
# spilling: the head's store, and puts that overflow it
STORE_BYTES = 32 << 20
SPILL_PUTS, SPILL_BYTES = 6, 8 << 20


@pytest.fixture(scope="module")
def clusters():
    """Both clusters, started once for the module: a head {CPU 2,
    head_res 1} with a small store, and a second node {CPU 2, other_res
    1}; the driver of each package attached. Workers run torch on one
    intra-op thread."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    cloudpickle.register_pickle_by_value(torch_cluster_tasks)
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    out = {}
    try:
        for name, pkg, cls in (("jax", ray_tpu, JaxCluster),
                               ("torch", ray_tpu_torch, TorchCluster)):
            c = cls()
            out[name] = (pkg, c)
            c.add_node(num_cpus=2, resources={"head_res": 1},
                       store_capacity=STORE_BYTES, infeasible_timeout_s=2.0)
            c.add_node(num_cpus=2, resources={"other_res": 1},
                       infeasible_timeout_s=2.0)
            c.wait_for_nodes(2)
            pkg.init(address=c.gcs_address)
        yield out
    finally:
        for pkg, c in out.values():
            pkg.shutdown()
            c.shutdown()
        cloudpickle.unregister_pickle_by_value(torch_cluster_tasks)
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved


def both(clusters, scenario):
    """``scenario(pkg)`` on each package's cluster; the two results."""
    return {name: scenario(clusters[name][0]) for name in PACKAGES}


def error_name(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__
    return "no error"


def wait_gone(pid: int, timeout: float = 30.0) -> bool:
    """Whether process ``pid`` exits (or is left a zombie) in time."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.05)
    return False


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------

def test_tasks_object_refs_and_processes(clusters):
    def scenario(pkg):
        f, p, d = (pkg.remote(fn) for fn in (add, pid, double))
        return [pkg.get(f.remote(2, 3)), pkg.get(p.remote()) != os.getpid(),
                pkg.get(d.remote(d.remote(10)))]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [5, True, 40]


def test_put_get_numpy_and_errors(clusters):
    arr = np.arange(100_000, dtype=np.float32)

    def scenario(pkg):
        out = pkg.get(pkg.put(arr))
        return [out.dtype.str, out.tobytes() == arr.tobytes(),
                error_name(lambda: pkg.get(pkg.remote(boom).remote()))]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == ["<f4", True, "TaskError"]


def test_parallel_tasks_results(clusters):
    def scenario(pkg):
        s = pkg.remote(sleep_then)
        return sorted(pkg.get([s.remote(i, 0.2) for i in range(4)]))

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [0, 1, 2, 3]


def test_actors_named_actors_and_death(clusters):
    def scenario(pkg):
        c = pkg.remote(Counter).remote(10)
        order = pkg.get([c.incr.remote() for _ in range(5)])
        value = pkg.get(c.value.remote())
        r = pkg.remote(Registry).options(name="registry").remote()
        pkg.get(r.set.remote("a", 1))
        named = pkg.get(pkg.get_actor("registry").get.remote("a"))
        p = pkg.remote(Pinger).remote()
        pong = pkg.get(p.ping.remote())
        worker = pkg.get(p.pid.remote())
        pkg.kill(p)
        # kill() returns once the GCS holds the actor dead; its worker
        # takes a SIGTERM and may still answer a call pushed before it
        # exits (JAX's under load), so the call goes after the exit
        gone = wait_gone(worker)
        dead = error_name(lambda: pkg.get(p.ping.remote(), timeout=15))
        pkg.kill(r)
        pkg.kill(c)
        return [order, value, named, pong, gone, dead]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"]
    assert got["jax"][:5] == [[11, 12, 13, 14, 15], 15, 1, "pong", True]
    assert got["jax"][5] == "ActorDiedError"


def test_wait(clusters):
    def scenario(pkg):
        s = pkg.remote(sleep_then)
        fast, slow = s.remote(1, 0.0), s.remote(2, 1.5)
        pkg.get(fast)
        ready, not_ready = pkg.wait([fast, slow], num_returns=1,
                                    timeout=0.3)
        return [ready == [fast], not_ready == [slow], pkg.get(slow)]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, True, 2]


def test_cluster_resources(clusters):
    got = both(clusters, lambda pkg: {k: v for k, v in
                                      pkg.cluster_resources().items()
                                      if k != "TPU"})
    assert got["torch"] == got["jax"]
    assert got["jax"]["CPU"] == 4.0 and got["jax"]["other_res"] == 1.0


def test_cross_node_scheduling_and_transfer(clusters):
    def scenario(pkg):
        n = pkg.remote(node_of)
        other = pkg.get(n.options(resources={"other_res": 1})
                        .remote(pkg.__name__))
        head = pkg.get(n.options(resources={"head_res": 1})
                       .remote(pkg.__name__))
        made = pkg.remote(produce).options(resources={"other_res": 1})
        used = pkg.remote(consume).options(resources={"head_res": 1})
        return [other != head, pkg.get(used.remote(made.remote()))]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, 50_000.0]


def test_infeasible_task_errors(clusters):
    """No node can ever fit the demand: after the parked task's grace the
    raylet seals a typed error."""
    got = both(clusters, lambda pkg: error_name(lambda: pkg.get(
        pkg.remote(num_cpus=64)(add).remote(1, 2), timeout=15)))
    assert got["torch"] == got["jax"] == "WorkerCrashedError"


def test_memstore_put_refs_resolve_everywhere(clusters):
    def scenario(pkg):
        a, b = pkg.put(20), pkg.put(22)
        total = pkg.get(pkg.remote(add_nested).remote(pkg.__name__, (a, b)))
        back = pkg.get(pkg.remote(passthrough).remote([a]))
        return [total, pkg.get(back[0])]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [42, 20]


def test_placement_group_table(clusters):
    def scenario(pkg):
        rpc = importlib.import_module(f"{pkg.__name__}.runtime.rpc")
        client = rpc.RpcClient(clusters[
            "jax" if pkg is ray_tpu else "torch"][1].gcs_address)
        try:
            made = client.call("create_placement_group", pg_id="pg1",
                               bundles=[{"CPU": 1}, {"CPU": 1}],
                               strategy="PACK")
            info = client.call("get_placement_group", pg_id="pg1")
            client.call("remove_placement_group", pg_id="pg1")
            gone = client.call("get_placement_group", pg_id="pg1")
        finally:
            client.close()
        return [made["ok"], info["state"], len(info["bundle_nodes"]),
                len(set(info["bundle_nodes"])), gone]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, "CREATED", 2, 1, None]


def test_spilling_past_the_store(clusters):
    """Puts that overflow the head's store spill to disk and each comes
    back equal. The port's values own their memory, so one read earlier
    stays equal while later reads restore and spill (a JAX array aliases
    its store slot, which the store may reuse under pressure: only the
    read-then-compare half is JAX's contract)."""
    arrays = [np.full(SPILL_BYTES // 4, i, dtype=np.float32)
              for i in range(SPILL_PUTS)]
    kept = {}

    def scenario(pkg):
        refs = [pkg.put(a) for a in arrays]
        equal = [np.array_equal(pkg.get(r), a) for r, a in zip(refs, arrays)]
        kept[pkg.__name__] = [pkg.get(r) for r in refs]
        head = next(h for h in (clusters["jax" if pkg is ray_tpu
                                         else "torch"][1].nodes.values())
                    if h.raylet.labels.get("head"))
        return [all(equal), head.raylet.spill_stats["num_spilled"] > 0]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, True]
    assert all(np.array_equal(x, a) for x, a in zip(
        kept["ray_tpu_torch"], arrays))


def test_external_gcs_and_node_processes():
    """``Cluster(external_gcs=True)`` runs the GCS as its own process
    (``python -m <package>.runtime.gcs``), ``add_node(external=True)`` a
    raylet process (``python -m <package>.runtime.raylet``); the node
    registers with its resources, ``remove_node`` kills its process and
    the GCS holds the node dead after the heartbeat timeout. No driver
    attaches: the module's clusters keep theirs."""
    def scenario(pkg):
        cls = JaxCluster if pkg is ray_tpu else TorchCluster
        rpc = importlib.import_module(f"{pkg.__name__}.runtime.rpc")
        c = cls(external_gcs=True, heartbeat_timeout_s=1.0)
        try:
            node = c.add_node(num_cpus=1, resources={"ext_res": 1},
                              external=True)
            c.wait_for_nodes(1)
            client = rpc.RpcClient(c.gcs_address)
            try:
                seen = [(n["node_id"] == node.node_id,
                         {k: v for k, v in n["resources"].items()
                          if k != "TPU"})
                        for n in client.call("get_nodes", alive_only=True)]
                processes = [c._gcs_proc.pid != os.getpid(),
                             c._gcs_proc.poll() is None,
                             node.proc.poll() is None]
                c.remove_node(node)
                deadline = time.monotonic() + 30
                while (client.call("get_nodes", alive_only=True)
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                dead = [n["alive"] for n in
                        client.call("get_nodes", alive_only=False)]
            finally:
                client.close()
            gcs = c._gcs_proc
        finally:
            c.shutdown()
        return [seen, processes, node.proc.returncode, dead,
                gcs.poll() is not None]

    got = {name: scenario(pkg) for name, pkg in (("jax", ray_tpu),
                                                 ("torch", ray_tpu_torch))}
    assert got["torch"] == got["jax"] == [
        [(True, {"CPU": 1.0, "ext_res": 1.0})], [True, True, True], -9,
        [False], True]


# ---------------------------------------------------------------------------
# tests/test_lease.py
# ---------------------------------------------------------------------------

def test_lease_reuses_workers(clusters):
    def scenario(pkg):
        p = pkg.remote(pid).options(resources={"other_res": 0.001})
        return len(set(pkg.get([p.remote() for _ in range(40)]))) <= 2

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] is True


def test_worker_death_retries_and_fails_typed(clusters):
    def scenario(pkg):
        marker = tempfile.mktemp(prefix="lease_die_once_")
        try:
            again = pkg.get(pkg.remote(max_retries=1)(die_once)
                            .remote(marker), timeout=30)
        finally:
            if os.path.exists(marker):
                os.unlink(marker)
        crashed = error_name(lambda: pkg.get(
            pkg.remote(max_retries=0)(die).remote(), timeout=30))
        return [again, crashed]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == ["second attempt",
                                          "WorkerCrashedError"]


def test_return_refs_registered_before_the_pusher(clusters):
    """The return refs count a live instance before the task reaches a
    lease pusher (a direct result arriving first would be dropped)."""
    def scenario(pkg):
        core = importlib.import_module(f"{pkg.__name__}.runtime.core")
        rt = core.get_runtime()
        lm, counts = rt._leases, []
        orig = lm.submit

        def spy(task):
            counts.extend(rt._refs.count(o)
                          for o in task.get("return_oids", ()))
            orig(task)

        lm.submit = spy
        try:
            e = pkg.remote(double)
            out = pkg.get([e.remote(i) for i in range(20)], timeout=30)
        finally:
            lm.submit = orig
        return [out == [2 * i for i in range(20)], bool(counts),
                min(counts) >= 1]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, True, True]


# ---------------------------------------------------------------------------
# tests/test_cluster_extras.py and tests/test_util_extras.py: placement
# groups, the internal KV and multiprocessing.Pool on a cluster
# ---------------------------------------------------------------------------

def test_placement_group_strategy_places_a_task_and_an_actor(clusters):
    """JAX's ``test_placement_group_api_and_strategy``: a PACK group of two
    bundles that ask for ``other_res`` is CREATED on the second node, and
    a task under ``PlacementGroupSchedulingStrategy`` runs on a bundle's
    node, which a plain ``other_res`` task finds once the group is gone.
    The port's actor takes the strategy too and lands there; JAX's
    refuses the option."""
    def scenario(pkg):
        pgm = importlib.import_module(f"{pkg.__name__}.util.placement_group")
        pg = pgm.placement_group([{"CPU": 1, "other_res": 0.5}] * 2,
                                 strategy="PACK")
        try:
            ready = pg.ready(timeout=10)
            table = pgm.placement_group_table(pg)
            strategy = pgm.PlacementGroupSchedulingStrategy(pg)
            node = pkg.get(pkg.remote(num_cpus=1, scheduling_strategy=strategy)
                           (node_of).remote(pkg.__name__), timeout=60)
            try:
                actor = pkg.remote(NodeOf).options(
                    num_cpus=1, scheduling_strategy=strategy).remote()
            except ValueError as e:
                actor_node = type(e).__name__
            else:
                actor_node = pkg.get(actor.node.remote(pkg.__name__),
                                     timeout=60) in table["bundle_nodes"]
                pkg.kill(actor)
        finally:
            pgm.remove_placement_group(pg)
        other = pkg.get(pkg.remote(node_of).options(
            resources={"other_res": 1}).remote(pkg.__name__), timeout=60)
        return [ready, table["state"], len(set(table["bundle_nodes"])),
                node in table["bundle_nodes"], node == other, actor_node]

    got = both(clusters, scenario)
    assert got["jax"] == [True, "CREATED", 1, True, True, "ValueError"]
    assert got["torch"] == [True, "CREATED", 1, True, True, True]


def test_internal_kv_on_the_gcs(clusters):
    """JAX's ``test_internal_kv_cluster``: the driver's put is read by a
    task in a worker process (through the GCS); then the rest of the API
    on the GCS's table."""
    def scenario(pkg):
        kv = importlib.import_module(f"{pkg.__name__}.experimental")
        put = kv.internal_kv_put("shared", b"cluster-val")
        kept = kv.internal_kv_put("shared", b"other", overwrite=False)
        read = pkg.get(pkg.remote(kv_read).remote(pkg.__name__, "shared"))
        listed = kv.internal_kv_list("sha")
        deleted = kv.internal_kv_del("shared")
        return [put, kept, read, listed, deleted,
                kv.internal_kv_get("shared")]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [True, False, b"cluster-val",
                                          ["shared"], True, None]


def test_pool_tasks_reach_cluster_workers(clusters):
    """``multiprocessing.Pool`` on a cluster: its tasks run in worker
    processes, the initializer once in each, ``map``, ``apply`` and
    ``starmap`` as in the stdlib. The port's pool task (a module-level
    callable class) goes by stdlib pickle."""
    def scenario(pkg):
        mp = importlib.import_module(f"{pkg.__name__}.util.multiprocessing")
        with mp.Pool(2, initializer=set_env,
                     initargs=("POOL_INIT_V", "9")) as pool:
            return [pool.map(double, range(6)),
                    pool.apply(pid) != os.getpid(),
                    pool.map(read_env, ["POOL_INIT_V"]),
                    pool.starmap(add, [(1, 2), (3, 4)])]

    got = both(clusters, scenario)
    assert got["torch"] == got["jax"] == [[0, 2, 4, 6, 8, 10], True, ["9"],
                                          [3, 7]]


# ---------------------------------------------------------------------------
# only the port: torch tensors, and the driver's __main__
# ---------------------------------------------------------------------------

def test_torch_tensors_bit_for_bit(clusters):
    """float32, bfloat16 and int64 tensors nested in a dict, through
    ``put``, a task's arguments and its return, keep dtype, shape and
    bits."""
    gen = torch.Generator().manual_seed(0)
    tree = {"t": {"f32": torch.randn(3, 5, generator=gen),
                  "bf16": torch.randn(4, 7, generator=gen).to(
                      torch.bfloat16),
                  "i64": torch.randint(-2**40, 2**40, (6,), generator=gen)},
            "note": "x"}
    pkg = ray_tpu_torch

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a, b)

    via_put = pkg.get(pkg.put(tree))
    seen = pkg.get(pkg.remote(describe).remote(tree))
    back = pkg.get(pkg.remote(tensors_back).remote(tree))
    want = describe(tree)
    assert seen == want
    for got in (via_put, back):
        assert got["note"] == "x"
        assert all(same(got["t"][k], v) for k, v in tree["t"].items())


MAIN_SCRIPT = textwrap.dedent("""
    import json, os, sys

    def where():
        return {"name": __name__, "main": sys.modules["__main__"].__name__,
                "main_ran": "MAIN_RAN" in globals(), "pid": os.getpid()}

    if __name__ == "__main__":
        MAIN_RAN = True
        import ray_tpu_torch
        from ray_tpu_torch.cluster_utils import Cluster

        c = Cluster()
        c.add_node(num_cpus=1)
        ray_tpu_torch.init(address=c.gcs_address)
        try:
            got = ray_tpu_torch.get(ray_tpu_torch.remote(where).remote())
            print(json.dumps({**got, "driver_pid": os.getpid()}))
        finally:
            ray_tpu_torch.shutdown()
            c.shutdown()
""")


def test_main_function_reaches_a_worker_as_mp_main(tmp_path):
    script = tmp_path / "driver_main.py"
    script.write_text(MAIN_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["name"] == "__mp_main__" and got["main"] == "__mp_main__"
    assert got["main_ran"] is False
    assert got["pid"] != got["driver_pid"]


def test_a_body_pickle_cannot_carry_raises_type_error(clusters):
    pkg = ray_tpu_torch

    def local(x):
        return x

    with pytest.raises(TypeError, match="module level"):
        pkg.remote(local).remote(1)
    with pytest.raises(TypeError, match="module level"):
        pkg.remote(add).remote(lambda: 1, 2)
