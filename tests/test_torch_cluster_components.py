"""The cluster runtime's parts, the port's against the JAX package's.

With no cluster booted: the shared-memory store binding (the port builds
its own copy of the C++ store, ``csrc/host/shm_store.cc``), the native
scheduling policy (``csrc/host/scheduling.cc``), the RPC framing of
pickled and cross-language (msgpack) messages, the worker pool's and the
task scheduler's units of ``tests/test_raylet_components.py``, and the
lease manager's task shapes. Each runs the same steps on both packages
and the results must be equal: exact values, error types and orderings,
and the same bytes on the wire.
"""

import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np
import pytest

from ray_tpu._private import scheduling as jsched
from ray_tpu._private import shm_store as jstore
from ray_tpu.runtime import lease as jlease
from ray_tpu.runtime import rpc as jrpc
from ray_tpu.runtime import scheduler as jscheduler
from ray_tpu.runtime import worker_pool as jpool
from ray_tpu_torch._private import scheduling as tsched
from ray_tpu_torch._private import shm_store as tstore
from ray_tpu_torch.runtime import lease as tlease
from ray_tpu_torch.runtime import rpc as trpc
from ray_tpu_torch.runtime import scheduler as tscheduler
from ray_tpu_torch.runtime import worker_pool as tpool

STORES = {"jax": jstore, "torch": tstore}


@pytest.fixture(scope="module", autouse=True)
def jax_libraries():
    """The JAX package's store build (``make -C src``) also builds its
    scheduling library. Its binding looks for the library once and
    remembers a miss (``tests/test_cpp_scheduler.py`` asks at import,
    maybe before any build), so it looks again here."""
    jstore.get_lib()
    jsched._checked = False
    assert jsched.available()


def oid(n: int) -> bytes:
    return n.to_bytes(4, "big") + b"\x00" * 16


def outcome(fn):
    """``fn()``'s value, or its error's type name."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__


# ---------------------------------------------------------------------------
# the shared-memory store (tests/test_shm_store.py)
# ---------------------------------------------------------------------------

def store_trace(mod, name: str) -> list:
    """Every single-process scenario of tests/test_shm_store.py on one
    binding, as a list of outcomes."""
    s = mod.ShmObjectStore(name, capacity=1 << 20, create=True)
    out = []
    try:
        s.put(oid(1), b"hello world")
        out.append(bytes(s.get(oid(1))))
        s.release(oid(1))
        buf = s.create(oid(2), 5)
        buf[:] = b"abcde"
        del buf
        out.append(s.contains(oid(2)))
        s.seal(oid(2))
        out += [s.contains(oid(2)), bytes(s.get(oid(2)))]
        s.release(oid(2))
        s.put(oid(3), b"x")
        out.append(outcome(lambda: s.create(oid(3), 1)))
        out.append(outcome(lambda: s.get(oid(99), timeout_ms=-1)))
        out.append(outcome(lambda: s.get(oid(98), timeout_ms=50)))
        s.put(oid(4), b"data")
        view = s.get(oid(4))
        out.append(s.delete(oid(4)))
        del view
        s.release(oid(4))
        out += [s.delete(oid(4)), s.contains(oid(4))]
        out.append(outcome(lambda: s.create(oid(6), 2 << 20)))
        # LRU eviction of unreferenced objects; a pinned one survives
        pinned = s.get(oid(1))
        for i in range(20):
            s.put(oid(100 + i), b"z" * (100 * 1024))
        st = s.stats()
        out += [st["num_evictions"] > 0, s.contains(oid(119)),
                s.contains(oid(100)), s.contains(oid(1)),
                bytes(pinned[:5])]
        del pinned
        s.release(oid(1))
        # an unsealed (crashed writer's) entry is reclaimed
        s.create(oid(10), 100)
        out += [s.evict_orphans(),
                outcome(lambda: s.get(oid(10), timeout_ms=-1))]
        # batched reads: hits hold refs, misses and unsealed are None
        s.put(oid(20), b"a" * 64)
        s.put(oid(21), b"b" * 128)
        s.create(oid(22), 16)
        views = s.get_many([oid(20), oid(99), oid(21), oid(22)])
        out.append([None if v is None else bytes(v) for v in views])
        del views
        out.append(s.delete(oid(20)))
        s.release_many([oid(20), oid(21)])
        out += [s.delete(oid(20)), s.delete(oid(21))]
        s.put(oid(30), b"dup")
        views = s.get_many([oid(30)] * 5)
        del views
        out.append(s.delete(oid(30)))
        s.release_many([oid(30)] * 5)
        out.append(s.delete(oid(30)))
        s.put(oid(40), b"x")
        s.release_many([oid(40), oid(41), oid(40)])
        out.append(s.delete(oid(40)))
        # alternating alloc/free coalesces the free list back to empty
        for round_ in range(3):
            for i in range(50):
                s.put(oid(1000 + i), bytes([round_]) * (1024 * (1 + i % 7)))
            for i in range(0, 50, 2):
                s.delete(oid(1000 + i))
            for i in range(1, 50, 2):
                s.delete(oid(1000 + i))
        s.abort(oid(22))
        st = s.stats()
        out.append({k: st[k] for k in ("capacity", "num_objects",
                                       "bytes_allocated")})
    finally:
        s.close()
    return out


def test_store_binding_operations_and_errors():
    got = {k: store_trace(m, f"/rtt_cmp_{k}_{os.getpid()}")
           for k, m in STORES.items()}
    assert got["torch"] == got["jax"]
    assert got["jax"][4:7] == ["ObjectExistsError", "ObjectNotFoundError",
                               "ObjectNotFoundError"]
    assert got["jax"][10] == "StoreFullError"


def _child_reader(pkg: str, name: str, object_id: bytes, q, crash: bool):
    mod = STORES[pkg]
    s = mod.ShmObjectStore(name)
    view = s.get(object_id, timeout_ms=5000)
    q.put((bytes(view), os.getpid()))
    if crash:
        q.close()
        q.join_thread()
        os._exit(1)   # crash while holding the read ref
    del view
    s.release(object_id)
    s.close()


def test_store_across_processes():
    """A spawned process reads an object; a crashed reader's ref is
    reclaimed by its pid."""
    ctx = mp.get_context("spawn")
    got = {}
    for pkg, mod in STORES.items():
        s = mod.ShmObjectStore(f"/rtt_cmpx_{pkg}_{os.getpid()}",
                               capacity=1 << 20, create=True)
        try:
            s.put(oid(8), b"cross-process payload")
            out = []
            for crash in (False, True):
                q = ctx.Queue()
                p = ctx.Process(target=_child_reader,
                                args=(pkg, s.name, oid(8), q, crash))
                p.start()
                try:
                    data, pid = q.get(timeout=60)
                finally:
                    p.join(timeout=30)
                    if p.is_alive():
                        p.kill()
                        p.join()
                out.append(data)
            out += [s.delete(oid(8)), s.release_pid(pid), s.delete(oid(8))]
            got[pkg] = out
        finally:
            s.close()
    assert got["torch"] == got["jax"] == [b"cross-process payload"] * 2 + [
        False, 1, True]


def test_store_loads_no_library_of_the_jax_package():
    import ray_tpu_torch._private.build as build

    lib = tstore.get_lib()
    assert os.path.dirname(lib._name) == str(build.BUILD_DIR)
    assert "ray_tpu/_private" not in lib._name


# ---------------------------------------------------------------------------
# the native scheduling policy (tests/test_cpp_scheduler.py)
# ---------------------------------------------------------------------------

def test_native_policy_picks_equal_jax():
    rng = np.random.default_rng(0)
    kinds = ("CPU", "GPU", "memory", "custom")
    for _ in range(300):
        n = int(rng.integers(1, 7))
        totals, avails = [], []
        for _ in range(n):
            t = {k: float(rng.integers(0, 9)) for k in kinds
                 if rng.random() < 0.8}
            if rng.random() < 0.2:
                t["memory"] = float(rng.integers(1, 64)) * 1e9
            totals.append(t)
            avails.append({k: float(rng.integers(0, int(v) + 1)) if
                           v < 1e6 else float(rng.integers(0, 64)) * 1e9
                           for k, v in t.items()})
        ids = [f"n{i}" for i in range(n)]
        alive = [bool(rng.random() < 0.9) for _ in range(n)]
        excluded = {i for i in ids if rng.random() < 0.1}
        demand = {k: float(rng.integers(0, 4)) for k in kinds
                  if rng.random() < 0.5} or {"CPU": 1.0}
        kw = dict(spread_threshold=float(rng.choice([0.0, 0.5])),
                  top_k=int(rng.integers(1, 3)),
                  seed=int(rng.integers(0, 1 << 30)))
        args = (ids, totals, avails, alive, excluded, demand)
        assert tsched.pick_node(*args, **kw) == jsched.pick_node(*args, **kw)
        assert tsched.score_nodes(totals, avails, alive, demand) == \
            jsched.score_nodes(totals, avails, alive, demand)


def test_gcs_picks_equal_jax():
    """The GCS's node choice for resource demands (the native policy)
    and for empty ones (the Python score) over the same node table."""
    from ray_tpu.runtime import gcs as jgcs
    from ray_tpu_torch.runtime import gcs as tgcs

    rng = np.random.default_rng(1)
    picks = {}
    for name, gcs in (("jax", jgcs), ("torch", tgcs)):
        server = gcs.GcsServer()
        try:
            rng = np.random.default_rng(1)
            for i in range(5):
                res = {"CPU": float(rng.integers(1, 9)),
                       "GPU" if name == "torch" else "TPU": 1.0}
                server._nodes[f"n{i}"] = gcs.NodeInfo(
                    node_id=f"n{i}", address=("127.0.0.1", i),
                    store_name="-", resources=res,
                    available={k: float(rng.integers(0, int(v) + 1))
                               for k, v in res.items()})
            demands = [{"CPU": float(c)} for c in range(0, 5)] + [{}]
            picks[name] = [server._pick_node(d) for d in demands]
        finally:
            server.stop()
    assert picks["torch"] == picks["jax"]


def gcs_persistence_trace(gcs, rpc, path: str) -> list:
    """KV and job records through a GCS with a persistence directory:
    stopped (a snapshot), restarted from it; then one more record and a
    crash (no snapshot: the WAL carries it), restarted again."""
    def restart():
        server = gcs.GcsServer(persistence_dir=path).start()
        return server, rpc.RpcClient(server.address)

    def read(client):
        return [sorted(client.call("kv_keys", ns="ns")),
                client.call("kv_get", ns="ns", key="a"),
                [(j["job_id"], j["state"], j["metadata"])
                 for j in client.call("list_jobs")]]

    out = []
    server, client = restart()
    client.call("kv_put", ns="ns", key="a", value=b"\x00\x01")
    client.call("kv_put", ns="ns", key="b", value=b"bee")
    out.append(client.call("kv_put", ns="ns", key="a", value=b"no",
                           overwrite=False))
    client.call("kv_del", ns="ns", key="b")
    client.call("register_job", job_id="j1", metadata={"who": "test"})
    client.close()
    server.stop()
    server, client = restart()
    out.append(read(client))
    client.call("kv_put", ns="ns", key="c", value=b"wal")
    client.close()
    server._persist.close()
    server._persist = None          # a crash: stop() writes no snapshot
    server.stop()
    server, client = restart()
    try:
        out.append(read(client))
        out.append(client.call("kv_get", ns="ns", key="c"))
    finally:
        client.close()
        server.stop()
    return out


def test_gcs_persistence_equal_jax(tmp_path):
    """``GcsPersistence``: state back after a stop (snapshot) and after a
    crash (WAL replay), the same on both packages."""
    from ray_tpu.runtime import gcs as jgcs
    from ray_tpu_torch.runtime import gcs as tgcs

    got = {name: gcs_persistence_trace(gcs, rpc, str(tmp_path / name))
           for name, gcs, rpc in (("jax", jgcs, jrpc),
                                  ("torch", tgcs, trpc))}
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == {"ok": False}
    assert got["jax"][1] == [["a"], b"\x00\x01",
                             [("j1", "RUNNING", {"who": "test"})]]
    assert got["jax"][2][0] == ["a", "c"] and got["jax"][3] == b"wal"


# ---------------------------------------------------------------------------
# the wire (runtime/rpc.py, runtime/xlang.py)
# ---------------------------------------------------------------------------

MESSAGES = [
    {"method": "get_nodes", "_id": 3, "alive_only": True},
    {"method": "submit_task", "_id": 1 << 40,
     "task": {"task_id": "ab" * 8, "args_blob": b"\x80\x05.",
              "resources": {"CPU": 1.0}, "return_oids": ["cd" * 10]}},
    {"_id": 7, "result": [1, -5, 2.5, "x" * 40, None, True,
                          {"k": b"\x00" * 300}]},
]


def framed(mod, msg, fmt: str) -> bytes:
    a, b = socket.socketpair()
    try:
        mod.send_msg(a, msg, fmt=fmt)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("fmt", ["pickle", "msgpack"])
def test_framed_bytes_equal_jax(fmt):
    for msg in MESSAGES:
        want = framed(jrpc, msg, fmt)
        got = framed(trpc, msg, fmt)
        assert got == want
        a, b = socket.socketpair()
        try:
            a.sendall(got)
            assert trpc.recv_msg_any(b) == jrpc.recv_msg_any(
                _replay(want)) == (_norm(msg, fmt), fmt)
        finally:
            a.close()
            b.close()


def _replay(data: bytes):
    a, b = socket.socketpair()
    a.sendall(data)
    a.close()
    return b


def _norm(msg, fmt):
    """msgpack carries tuples as arrays and bytes as bin."""
    if fmt != "msgpack":
        return msg
    from ray_tpu_torch.runtime import xlang
    return xlang.loads(xlang.dumps(msg))


def test_rpc_round_trip_between_the_packages():
    """A port client calls a port server; a JAX client calls the same
    server: one wire, the same replies."""
    class Echo(trpc.RpcServer):
        def rpc_echo(self, conn, send_lock, *, x):
            return {"x": x}

        def rpc_fail(self, conn, send_lock):
            raise KeyError("nope")

    server = Echo().start()
    try:
        out = {}
        for name, mod in (("jax", jrpc), ("torch", trpc)):
            c = mod.RpcClient(server.address)
            try:
                out[name] = [c.call("echo", x=[1, "a", 2.5]),
                             outcome(lambda: c.call("fail")),
                             outcome(lambda: c.call("missing"))]
            finally:
                c.close()
        assert out["torch"] == out["jax"] == [
            {"x": [1, "a", 2.5]}, "KeyError", "AttributeError"]
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# worker pool and task scheduler units (tests/test_raylet_components.py)
# ---------------------------------------------------------------------------

class StubNode:
    """Minimal raylet stand-in for component unit tests."""

    def __init__(self):
        self.node_id = "a" * 32
        self._stopping = False
        self.kicked = 0
        self.released = []
        self.errors = []

        class store:  # noqa: N801 - stub namespace
            @staticmethod
            def evict_orphans(pid):
                pass

            @staticmethod
            def release_pid(pid):
                pass

        self.store = store

    def _kick_dispatch(self):
        self.kicked += 1

    def _release(self, demand):
        self.released.append(dict(demand))

    def _store_task_error(self, task, error):
        self.errors.append((task, error))

    def _forward(self, task, node_id, spill_count):
        return False


class FakeProc:
    def __init__(self):
        self.killed = False
        self.pid = 0

    def kill(self):
        self.killed = True

    def poll(self):
        return None


POOLS = {"jax": jpool, "torch": tpool}
SCHEDULERS = {"jax": jscheduler, "torch": tscheduler}


def pool_trace(mod) -> list:
    out = []
    from importlib import import_module

    env_key = import_module(
        mod.__name__.split(".")[0] + ".runtime_env").env_key
    pool = mod.WorkerPool(StubNode(), max_workers=2)
    pool.mark_bad_env("envkey", "pip exploded")
    out.append(pool.bad_env_error(None))
    pool._bad_envs[env_key(None)] = ("fresh", time.monotonic())
    out.append(pool.bad_env_error(None))
    pool._bad_envs[env_key(None)] = ("stale", time.monotonic() - 120)
    out.append(pool.bad_env_error(None))

    def handles(*specs):
        return {w.worker_id: w for w in (
            mod.WorkerHandle(worker_id=f"w{i}", proc=FakeProc(), **kw)
            for i, kw in enumerate(specs))}

    for specs in (
            [dict(state="busy", current_task={"max_retries": 2},
                  dispatched_at=1.0),
             dict(state="busy", current_task={"max_retries": 2},
                  dispatched_at=5.0),
             dict(state="busy", current_task={"max_retries": 0},
                  dispatched_at=9.0),
             dict(state="actor", dispatched_at=10.0)],
            [dict(state="leased", dispatched_at=2.0),
             dict(state="busy", current_task={"max_retries": 0},
                  dispatched_at=3.0)],
            [dict(state="idle")]):
        pool = mod.WorkerPool(StubNode(), max_workers=4)
        pool.workers = handles(*specs)
        out.append(pool.kill_one_for_memory())
        out.append(sorted(w for w, h in pool.workers.items()
                          if h.proc.killed and h.oom_killed))
    pool = mod.WorkerPool(StubNode(), max_workers=1)
    for i in range(300):
        w = mod.WorkerHandle(worker_id=f"w{i}", state="idle")
        pool.workers[w.worker_id] = w
        pool.on_worker_gone(w)
    out += [len(pool._death_info) <= 256, pool.death_info("w299"),
            pool.death_info("w0")]
    return out


def test_worker_pool_units_equal_jax():
    got = {k: pool_trace(m) for k, m in POOLS.items()}
    assert got["torch"] == got["jax"]
    assert got["jax"][:3] == [None, "fresh", None]
    assert got["jax"][3:9] == [True, ["w1"], True, ["w0"], False, []]


def scheduler_trace(mod) -> list:
    from importlib import import_module

    env_key = import_module(
        mod.__name__.split(".")[0] + ".runtime_env").env_key
    out = []

    def make(cpu=4.0):
        node = StubNode()
        return node, mod.TaskScheduler(node, resources={"CPU": cpu},
                                       infeasible_timeout_s=1.0)

    _, s = make(cpu=2.0)
    out += [s.try_acquire({"CPU": 1.5}), s.try_acquire({"CPU": 1.0}),
            s.avail_snapshot()["CPU"]]
    s.release({"CPU": 1.5})
    out += [s.avail_snapshot()["CPU"], s._dispatch_gen > 0]
    _, s = make()
    t1 = {"name": "a", "return_oids": ["aa"]}
    t2 = {"name": "b", "return_oids": ["bb"]}
    s.enqueue(t1)
    s.enqueue(t2)
    out += [s.take_queued_matching(lambda t: "bb" in t["return_oids"])
            is t2, list(s.ready) == [t1],
            s.take_queued_matching(lambda t: False)]
    _, s = make()
    bad = {"name": "bad", "runtime_env": {"env_vars": {"X": "1"}}}
    good = {"name": "good"}
    s.enqueue(bad)
    s.enqueue(good)
    out += [s.drop_queued_with_env(env_key(bad["runtime_env"])) == [bad],
            list(s.ready) == [good]]
    _, s = make()
    waiter = {"demand": {"CPU": 1}, "runtime_env": None,
              "event": threading.Event(), "result": None}
    with s.cv:
        s.lease_waiters.append(waiter)
    s.stop()
    out += [waiter["event"].is_set(), waiter["result"]]
    _, s = make()
    task = {"name": "t"}
    s.defer_enqueue(task, 0.05)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not s.ready:
        time.sleep(0.01)
    out.append(list(s.ready) == [task])
    node, s = make()

    class GcsStub:
        def call(self, *a, **k):
            return None

    node._gcs = GcsStub()
    node._gcs_lock = threading.Lock()
    big = {"name": "big", "return_oids": ["cc"]}
    s.park_infeasible(big, {"CPU": 64})
    out += [s.take_infeasible_matching(lambda t: "cc" in t["return_oids"])
            is big, s.take_infeasible_matching(lambda t: True)]
    return out


def test_task_scheduler_units_equal_jax():
    got = {k: scheduler_trace(m) for k, m in SCHEDULERS.items()}
    assert got["torch"] == got["jax"]
    assert got["jax"][:5] == [True, False, pytest.approx(0.5), 2.0, True]


# ---------------------------------------------------------------------------
# the lease manager's task shapes (runtime/lease.py)
# ---------------------------------------------------------------------------

def test_lease_shapes_equal_jax():
    tasks = [{"resources": {"CPU": 1.0}},
             {"resources": {"CPU": 1.0, "GPU": 0.5}},
             {"resources": {}, "strategy": {"kind": "SPREAD"}},
             {"resources": {"CPU": 2.0}, "strategy": {"kind": "DEFAULT"}},
             {"resources": {"CPU": 1.0}, "strategy": {"kind": "DEFAULT",
                                                     "pg_id": "p"}},
             {"resources": {"CPU": 1.0}, "runtime_env": {"pip": ["x"]}},
             {"resources": {"CPU": 1.0}, "strategy": {
                 "kind": "NODE_AFFINITY", "node_id": "n"}}]
    for t in tasks:
        assert tlease._leasable(t) == jlease._leasable(t)
        assert tlease._shape_key(t) == jlease._shape_key(t)
    info = {"last_words": ["a", "b", "c"]}
    for err in (ConnectionError("x"), TimeoutError("y")):
        assert type(tlease._typed_death_error({"name": "t"}, err,
                                              info)).__name__ == \
            type(jlease._typed_death_error({"name": "t"}, err,
                                           info)).__name__
    dead = {"node_unreachable": True, "node_id": "n1"}
    assert type(tlease._typed_death_error({}, OSError(), dead)).__name__ \
        == type(jlease._typed_death_error({}, OSError(), dead)).__name__ \
        == "NodeDiedError"
