"""The port's fault-injection plane against the JAX package's.

For a seeded plan and a fixed stream of consults, the port's plane
decides action for action what JAX's decides (message faults, seeded
probabilities, nth/every/max_hits, scoping by label, direction, method
and endpoint, connect gating, crash points by process label and glob).
Then the plane in each package's real RPC layer: a partition severs a
live ``RpcClient`` channel and refuses new dials until it is healed, a
dropped request times out, a duplicated one runs its handler twice, and
a reply the server drops never arrives. Last, the crash point
``gcs.after_wal_append`` in an in-process fault-tolerant GCS of each
package (the crash handler stands in for the process's death): after
``kill_gcs`` and ``restart_gcs`` the WAL restores the same tables in both.
"""

import threading

import pytest

from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu.runtime import fault_injection as jfi
from ray_tpu.runtime import rpc as jrpc
from ray_tpu_torch.cluster_utils import Cluster as TorchCluster
from ray_tpu_torch.runtime import fault_injection as tfi
from ray_tpu_torch.runtime import rpc as trpc

PACKAGES = {"jax": (jfi, jrpc, JaxCluster),
            "torch": (tfi, trpc, TorchCluster)}


@pytest.fixture(autouse=True)
def clean_planes():
    for fi, _, _ in PACKAGES.values():
        fi.plane.clear()
    yield
    for fi, _, _ in PACKAGES.values():
        fi.stop_kv_watcher()
        fi.plane.set_crash_handler(None)
        fi.plane.clear()


PLAN = {"version": 3, "seed": 42,
        "endpoints": {"gcs": ["127.0.0.1:6379"], "r": ["10.0.0.2:7000"]},
        "rules": [
            {"id": "p-drop", "fault": "drop", "src": "driver", "p": 0.3},
            {"fault": "duplicate", "method": "request_lease",
             "src": "raylet", "direction": "recv", "max_hits": 2},
            {"fault": "reset", "dst": "gcs", "every": 4},
            {"fault": "delay", "delay_s": 0.0, "method": "kv_get"},
            {"fault": "drop", "dst": "r", "nth": 3},
            {"fault": "partition", "src": "worker", "dst": "10.0.0.9:1",
             "direction": "send"},
            {"fault": "crash", "point": "worker.*", "proc": "worker",
             "p": 0.5},
            {"fault": "kill_template", "method": "fork_worker", "nth": 2},
        ]}

LABELS = ("driver", "raylet", "worker", "gcs", None, "fault-control")
DIRECTIONS = ("send", "recv")
PEERS = (("127.0.0.1", 6379), "10.0.0.2:7000", ("10.0.0.9", 1), "h:1")
METHODS = ("request_lease", "kv_get", "kv_put", "fork_worker", None)


def _consult_stream(fi) -> list:
    """The same 400 consults, connects and crash points on a fresh plane
    loaded with ``PLAN``."""
    plane = fi.FaultPlane()
    plane.load_plan(PLAN)
    plane.process_label = "worker"
    died = []
    plane.set_crash_handler(lambda point, rule: died.append(
        (point, rule.rid)))
    out = []
    for i in range(400):
        label = LABELS[i % len(LABELS)]
        peer = PEERS[(i // 3) % len(PEERS)]
        method = METHODS[(i // 7) % len(METHODS)]
        direction = DIRECTIONS[(i // 2) % 2]
        out.append(plane.consult(label, direction, peer, method))
        if i % 5 == 0:
            try:
                plane.check_connect(label, peer)
                out.append("connect")
            except OSError as e:
                out.append(type(e).__name__)
        if i % 3 == 0:
            n = len(died)
            plane.maybe_crash(("worker.mid_task", "gcs.after_wal_append",
                               "worker.mid_actor_task")[(i // 3) % 3])
            out.append(died[n:])
    out.append(sorted(plane.stats.items()))
    return out


def test_seeded_plan_decides_action_for_action():
    want = _consult_stream(jfi)
    got = _consult_stream(tfi)
    assert got == want
    # the stream exercises every kind of decision
    flat = {x for x in got if isinstance(x, str)}
    assert {"drop", "duplicate", "reset", "pass", "kill_template",
            "connect", "InjectedConnectionReset"} <= flat
    assert any(isinstance(x, list) and x and isinstance(x[0], tuple)
               for x in got)


def test_plan_forms_and_process_label():
    for fi, _, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown fault"):
            fi.FaultPlane().load_plan({"rules": [{"fault": "melt"}]})
    assert tfi.decode_plan(b'{"rules": []}') == jfi.decode_plan(
        b'{"rules": []}')
    with pytest.raises(ValueError):
        tfi.decode_plan("[1, 2]")
    assert tfi.CRASH_MARKER == jfi.CRASH_MARKER
    assert (tfi.KV_NS, tfi.KV_KEY) == (jfi.KV_NS, jfi.KV_KEY)
    # a fresh plane after fork, as JAX's
    tfi.plane.load_plan({"rules": [{"fault": "drop"}]})
    old = tfi.plane
    tfi.reset_after_fork()
    try:
        assert tfi.plane is not old and not tfi.plane.active
    finally:
        old.clear()


def _echo_server(rpc):
    class Echo(rpc.RpcServer):
        def __init__(self):
            super().__init__("127.0.0.1", 0)
            self.fault_label = "server"
            self.calls = 0
            self._calls_lock = threading.Lock()

        def rpc_echo(self, conn, send_lock, *, value):
            with self._calls_lock:
                self.calls += 1
            return {"value": value}

    return Echo().start()


def _rpc_scenario(fi, rpc) -> list:
    """Partition, heal, drop, duplicate and a dropped reply on a real
    server/client pair; returns what each step observed."""
    server = _echo_server(rpc)
    addr = f"{server.address[0]}:{server.address[1]}"
    out = []
    live = rpc.RpcClient(server.address, label="driver")
    try:
        out.append(live.call("echo", value=1, timeout=5)["value"])
        fi.plane.load_plan({"version": 1, "endpoints": {"srv": [addr]},
                            "rules": [{"fault": "partition", "src": "driver",
                                       "dst": "srv"}]})
        # the live channel is severed, new dials are refused
        try:
            live.call("echo", value=2, timeout=5)
            out.append("answered")
        except rpc.ConnectionLost:
            out.append("severed")
        try:
            rpc.RpcClient(server.address, label="driver")
            out.append("dialed")
        except fi.InjectedConnectionReset:
            out.append("refused")
        other = rpc.RpcClient(server.address, label="raylet")
        out.append(other.call("echo", value=3, timeout=5)["value"])
        other.close()
        fi.plane.load_plan({"version": 2, "rules": []})   # heal
        healed = rpc.RpcClient(server.address, label="driver")
        out.append(healed.call("echo", value=4, timeout=5)["value"])
        # a request dropped on the way out waits out its timeout
        fi.plane.load_plan({"version": 3, "rules": [
            {"fault": "drop", "src": "driver", "method": "echo",
             "direction": "send", "nth": 1}]})
        try:
            healed.call("echo", value=5, timeout=0.3)
            out.append("answered")
        except TimeoutError:
            out.append("timed out")
        # a duplicated request runs the handler twice, answers once
        before = server.calls
        fi.plane.load_plan({"version": 4, "rules": [
            {"fault": "duplicate", "src": "server", "direction": "recv",
             "method": "echo", "nth": 1}]})
        out.append(healed.call("echo", value=6, timeout=5)["value"])
        out.append(server.calls - before)
        # the server's reply is lost: the handler ran, the caller times out
        before = server.calls
        fi.plane.load_plan({"version": 5, "rules": [
            {"fault": "drop", "src": "server", "direction": "send",
             "method": "echo", "nth": 1}]})
        try:
            healed.call("echo", value=7, timeout=0.3)
            out.append("answered")
        except TimeoutError:
            out.append("timed out")
        out.append(server.calls - before)
        fi.plane.load_plan({"version": 6, "rules": []})
        out.append(healed.call("echo", value=8, timeout=5)["value"])
        healed.close()
    finally:
        live.close()
        server.stop()
    return out


def test_rpc_layer_partition_heal_drop_duplicate():
    want = _rpc_scenario(jfi, jrpc)
    got = _rpc_scenario(tfi, trpc)
    assert got == want
    assert got == [1, "severed", "refused", 3, 4, "timed out", 6, 2,
                   "timed out", 1, 8]


def _wal_crash_tables(fi, rpc, cluster_cls) -> dict:
    """Durable writes, then an injected death between a WAL append and
    its reply, then a crash-stop and a restart on the same address: the
    tables the restarted GCS serves."""
    c = cluster_cls(gcs_fault_tolerance=True)
    try:
        client = rpc.RpcClient(c.gcs_address)
        client.call("register_node", node_id="n1" * 16,
                    address=("127.0.0.1", 1), store_name="/s",
                    resources={"CPU": 2.0}, labels={"head": True})
        client.call("kv_put", ns="app", key="k1", value=b"v1")
        died = []

        def crash(point, rule):
            died.append((point, rule.rid))
            raise RuntimeError("injected crash")

        fi.plane.set_crash_handler(crash)
        client.call("kv_put", ns=fi.KV_NS, key=fi.KV_KEY, value={
            "version": 1, "rules": [
                {"id": "wal", "fault": "crash",
                 "point": "gcs.after_wal_append", "nth": 1}]})
        try:
            client.call("kv_put", ns="app", key="k2", value=b"v2",
                        overwrite=False)
            reply = "answered"
        except Exception:  # noqa: BLE001 - the reply lost to the crash
            reply = "lost"
        client.close()
        fi.plane.clear()
        c.kill_gcs()
        c.restart_gcs()
        fresh = rpc.RpcClient(c.gcs_address)
        try:
            tables = {
                "died": died, "reply": reply,
                "k1": fresh.call("kv_get", ns="app", key="k1"),
                "k2": fresh.call("kv_get", ns="app", key="k2"),
                "retry": fresh.call("kv_put", ns="app", key="k2",
                                    value=b"again", overwrite=False),
                "nodes": sorted((n["node_id"], n["resources"]["CPU"])
                                for n in fresh.call("get_nodes",
                                                    alive_only=False)),
                "restarts": c.gcs_restart_count,
            }
        finally:
            fresh.close()
        return tables
    finally:
        c.shutdown()


def test_wal_crash_point_and_restart_restore_the_same_tables():
    want = _wal_crash_tables(*PACKAGES["jax"])
    got = _wal_crash_tables(*PACKAGES["torch"])
    assert got == want
    assert got["died"] == [("gcs.after_wal_append", "wal")]
    assert got["k2"] == b"v2" and got["retry"] == {"ok": False}
