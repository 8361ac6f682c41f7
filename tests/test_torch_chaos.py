"""The port's crash chaos plane: supervisor, GCS restarts, failover, soak.

``Cluster.start_supervisor`` respawns a SIGKILLed external raylet under
its node id and records the same ``crash_events`` entry as JAX's; an
external fault-tolerant GCS that the plan kills at
``gcs.after_wal_append`` is restarted on its address with the write
durable and the crash point harvested from its last words. Then, on a
port cluster with the fault plane enabled (the scenarios of
``tests/test_crash_chaos.py``): an injected ``worker.mid_task`` death
surfaces as a typed error that names the crash point, and a replica
killed at ``replica.mid_request`` fails its caller typed-fast, is
replaced by the controller's health probe, and the deployment answers
again. Last the smoke soak at the size of JAX's
``test_smoke_soak_conservation_holds``: every submitted op resolves to a
value or a typed error.
"""

import os
import signal
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.runtime import fault_injection as fi
from ray_tpu_torch.runtime.rpc import ReconnectingRpcClient
from ray_tpu_torch.utils import exceptions as exc

import torch_runtime_tasks as tasks


def _respawn(cluster_cls) -> dict:
    c = cluster_cls(heartbeat_timeout_s=2.0)
    try:
        c.add_node(num_cpus=1)
        node = c.add_node(num_cpus=1, external=True)
        c.wait_for_nodes(2)
        c.start_supervisor(poll_s=0.1)
        old_pid = node.proc.pid
        os.kill(old_pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while not c.crash_events and time.monotonic() < deadline:
            time.sleep(0.05)
        assert c.crash_events, "the supervisor saw no death"
        ev = dict(c.crash_events[0])
        c.wait_for_nodes(2, timeout=20)
        return {"keys": sorted(ev), "class": ev["class"],
                "same_node": ev["node_id"] == node.node_id,
                "restart_count": ev["restart_count"],
                "recovered": ev["recovered_at"] >= ev["detected_at"],
                "new_proc": node.proc.pid != old_pid
                and node.proc.poll() is None,
                "crash_point": ev["crash_point"]}
    finally:
        c.shutdown()


def test_supervisor_respawns_a_killed_raylet_as_jax():
    want = _respawn(JaxCluster)
    got = _respawn(Cluster)
    assert got == want
    assert got["class"] == "raylet" and got["same_node"]
    assert got["restart_count"] == 1 and got["new_proc"]


def test_supervisor_restarts_a_gcs_killed_after_its_wal_append(
        monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAULT_INJECTION_ENABLED", "1")
    c = Cluster(gcs_fault_tolerance=True, external_gcs=True,
                heartbeat_timeout_s=2.0)
    try:
        c.start_supervisor(poll_s=0.1)
        fi.put_plan(c.gcs_address, {"version": 1, "rules": [
            {"id": "wal", "fault": "crash", "point": "gcs.after_wal_append",
             "proc": "gcs", "nth": 1}]})
        client = ReconnectingRpcClient(c.gcs_address)
        try:
            try:
                client.call("kv_put", ns="app", key="walkey", value=b"first",
                            overwrite=False)
            except Exception:  # noqa: BLE001 - the reply lost to the crash
                pass
            deadline = time.monotonic() + 30
            while (not any(e["class"] == "gcs" for e in c.crash_events)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            ev = next(e for e in c.crash_events if e["class"] == "gcs")
            assert ev["crash_point"] == "gcs.after_wal_append"
            assert any(fi.CRASH_MARKER in ln for ln in ev["last_words"])
            assert c.gcs_restart_count == 1
            # durable despite the lost reply, and the retry is absorbed
            assert client.call("kv_get", ns="app", key="walkey") == b"first"
            assert client.call("kv_put", ns="app", key="walkey",
                               value=b"second", overwrite=False) == {
                                   "ok": False}
        finally:
            client.close()
    finally:
        c.shutdown()


@pytest.fixture
def chaos_cluster(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAULT_INJECTION_ENABLED", "1")
    ray_tpu_torch.shutdown()
    fi.plane.clear()
    c = Cluster(heartbeat_timeout_s=2.0)
    c.add_node(num_cpus=4)
    ray_tpu_torch.init(address=c.gcs_address)
    yield c
    serve.shutdown()
    fi.put_plan(c.gcs_address, {"version": 99, "rules": []})
    ray_tpu_torch.shutdown()
    fi.stop_kv_watcher()
    c.shutdown()
    fi.plane.clear()


def test_worker_crash_and_replica_failover(chaos_cluster):
    c = chaos_cluster
    victim = ray_tpu_torch.remote(tasks.double)
    assert ray_tpu_torch.get(victim.remote(2), timeout=30) == 4
    fi.put_plan(c.gcs_address, {"version": 1, "rules": [
        {"id": "midtask", "fault": "crash", "point": "worker.mid_task",
         "proc": "worker", "nth": 1}]})
    time.sleep(0.6)   # workers poll the KV plan key
    with pytest.raises(exc.RayTpuError) as ei:
        ray_tpu_torch.get(victim.remote(3), timeout=30)
    assert not isinstance(ei.value, TimeoutError)
    assert "crash point worker.mid_task" in str(ei.value)
    fi.put_plan(c.gcs_address, {"version": 2, "rules": []})
    assert ray_tpu_torch.get(victim.remote(5), timeout=30) == 10

    h = serve.run(serve.deployment(num_replicas=2)(tasks.Echo).bind(),
                  name="echo_failover")
    assert h.call(1) == 1
    fi.put_plan(c.gcs_address, {"version": 3, "rules": [
        {"id": "midreq", "fault": "crash", "point": "replica.mid_request",
         "proc": "worker", "nth": 1, "max_hits": 1}]})
    time.sleep(0.6)
    t0 = time.monotonic()
    try:
        assert h.call(7) == 7
    except exc.ReplicaDiedError:
        pass
    assert time.monotonic() - t0 < 30
    fi.put_plan(c.gcs_address, {"version": 4, "rules": []})
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    deadline = time.monotonic() + 20
    done = []
    while time.monotonic() < deadline and not done:
        stats = ray_tpu_torch.get(controller.failover_stats.remote(),
                                  timeout=10)
        done = [e for e in stats["events"]
                if e["deployment"] == "echo_failover"
                and e.get("replaced_at") is not None]
        time.sleep(0.1)
    assert done, "no completed replacement in failover_stats"
    assert stats["replaced"].get("echo_failover", 0) >= 1
    deadline = time.monotonic() + 20
    while True:
        try:
            assert h.call(9) == 9
            break
        except exc.ReplicaDiedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.3)


def test_smoke_soak_conservation_holds():
    from ray_tpu_torch.chaos_soak import run_soak

    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    fi.plane.clear()
    report = run_soak(14.0, seed=11, classes=("worker", "replica"),
                      partitions=False, inject_period_s=4.0,
                      get_timeout_s=15.0, log=lambda *a: None)
    assert report["chaos_soak_invariant_violations"] == 0, \
        report["violations"]
    inj = {cls: ent["injections"]
           for cls, ent in report["per_class"].items()}
    assert inj.get("worker", 0) + inj.get("replica", 0) >= 2, inj
    for name, w in report["workloads"].items():
        assert w["untyped_errors"] == 0, (name, w)
    assert report["planes"]["crash_group_seen"]
