"""Multi-node-on-one-host cluster.

Port of ``ray_tpu/cluster_utils.py``; ``add_node(num_gpus=...)`` is JAX's
``num_tpus=`` renamed, with its default (0) kept. Reference analog:
``python/ray/cluster_utils.py:108`` — the workhorse for distributed
tests: N raylets (+1 GCS) as local processes sharing one machine; node
failure = kill the raylet process.

The GCS and the head raylet run in-process (threads); added nodes run as
separate OS processes (``add_node(external=True)``) so ``remove_node``
is a real process kill. With ``external_gcs=True`` the control plane is
its own process as well, and together with ``gcs_fault_tolerance=True``
it can be crash-killed and restarted on the same address with
WAL-replayed state (``GcsPersistence``).

``start_supervisor()`` turns the cluster into its own nanny: a poll loop
that respawns crashed external raylets under the SAME node id (the fresh
raylet's first heartbeat replays its node registration with the GCS) and
crash-restarts an external fault-tolerant GCS. Each detected death is
recorded in ``crash_events`` with detection/recovery timestamps — the
raw material for the chaos soak's per-class MTTR accounting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

from ray_tpu_torch.runtime.gcs import GcsServer
from ray_tpu_torch.runtime.raylet import Raylet
from ray_tpu_torch.utils.ids import NodeID


class NodeHandle:
    def __init__(self, node_id: str, *, raylet: Raylet | None = None,
                 proc: subprocess.Popen | None = None, address=None,
                 spawn_cfg: dict | None = None,
                 err_path: str | None = None):
        self.node_id = node_id
        self.raylet = raylet
        self.proc = proc
        self.address = address
        self.spawn_cfg = spawn_cfg     # external nodes: argv cfg for respawn
        self.err_path = err_path       # external nodes: stderr redirect file
        self.restart_count = 0
        self.removed = False           # deliberate remove: nanny must not respawn


class Cluster:
    """``Cluster()`` → ``add_node(num_cpus=...)`` → drive via
    ``ray_tpu_torch.init(address=cluster.gcs_address)``."""

    def __init__(self, *, heartbeat_timeout_s: float = 3.0,
                 external_gcs: bool = False,
                 gcs_fault_tolerance: bool = False):
        import tempfile

        self._hb_timeout = heartbeat_timeout_s
        self._gcs_persist_dir = None
        self._owns_persist_dir = False
        self._gcs_proc = None
        self._gcs_err_path = None
        self._external_gcs = external_gcs
        self.gcs_restart_count = 0
        # deaths the supervisor detected and repaired:
        # {"class", "node_id", "detected_at", "recovered_at",
        #  "restart_count", "crash_point", "last_words"}
        self.crash_events: list[dict] = []
        self._supervisor: threading.Thread | None = None
        self._supervise = False
        self._log_dir = tempfile.mkdtemp(prefix="rtt_cluster_")
        if gcs_fault_tolerance:
            self._gcs_persist_dir = tempfile.mkdtemp(prefix="rtt_gcs_")
            self._owns_persist_dir = True
        if external_gcs:
            # the control plane as its OWN process (the reference's
            # gcs_server is one too): its RPC handling must not share
            # the driver's GIL — the hot resource in submit benchmarks.
            self.gcs = None
            self.gcs_address = self._spawn_gcs_proc()
        else:
            self.gcs = GcsServer(
                heartbeat_timeout_s=heartbeat_timeout_s,
                persistence_dir=self._gcs_persist_dir).start()
            self.gcs_address = self.gcs.address
        self.nodes: dict[str, NodeHandle] = {}
        self._head_id: str | None = None
        self._lock = threading.Lock()

    # -- control-plane process management ------------------------------

    def _spawn_gcs_proc(self, host: str | None = None,
                        port: int | None = None) -> tuple:
        cfg = {"heartbeat_timeout_s": self._hb_timeout}
        if self._gcs_persist_dir is not None:
            cfg["persistence_dir"] = self._gcs_persist_dir
        if host is not None:
            cfg["host"] = host
            cfg["port"] = port
        err_path = self._gcs_err_path = os.path.join(self._log_dir,
                                                     "gcs.err")
        with open(err_path, "ab") as err_f:
            self._gcs_proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.runtime.gcs",
                 json.dumps(cfg)], env=_service_env(),
                stdout=subprocess.PIPE, stderr=err_f, text=True)
        line = self._gcs_proc.stdout.readline()
        if not line.strip():
            self._gcs_proc.kill()
            self._gcs_proc.wait()
            self._gcs_proc = None
            err = _read_tail(err_path)
            raise RuntimeError(
                f"external GCS process failed to start: {err[-2000:]}")
        return tuple(json.loads(line)["address"])

    def kill_gcs(self):
        """Chaos path: hard-stop the GCS WITHOUT a final snapshot (as a
        crash would), severing every client connection."""
        if self._gcs_proc is not None:
            self._gcs_proc.kill()
            self._gcs_proc.wait(timeout=10)
            self._gcs_proc = None
            return
        if self.gcs._persist is not None:
            self.gcs._persist.close()
            self.gcs._persist = None   # skip stop()'s snapshot
        self.gcs.stop()

    def restart_gcs(self):
        """Start a fresh GCS on the SAME address, reloading persisted
        state (reference: GCS fault-tolerance restart with Redis-backed
        reload — gcs_init_data.cc). Raylets/drivers reconnect via their
        ReconnectingRpcClient and re-register on the first heartbeat."""
        if self._gcs_persist_dir is None:
            raise RuntimeError(
                "restart_gcs requires Cluster(gcs_fault_tolerance=True)")
        host, port = self.gcs_address
        self.gcs_restart_count += 1
        if self._external_gcs:
            self.gcs_address = self._spawn_gcs_proc(host, port)
            return None
        self.gcs = GcsServer(
            host=host, port=port,
            heartbeat_timeout_s=self._hb_timeout,
            persistence_dir=self._gcs_persist_dir).start()
        self.gcs_address = self.gcs.address
        return self.gcs

    # ------------------------------------------------------------------

    def _spawn_raylet_proc(self, cfg: dict, err_path: str):
        with open(err_path, "ab") as err_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.runtime.raylet",
                 json.dumps(cfg)], env=_service_env(),
                stdout=subprocess.PIPE, stderr=err_f, text=True)
        line = proc.stdout.readline()
        if not line.strip():
            proc.kill()
            proc.wait()
            err = _read_tail(err_path)
            raise RuntimeError(
                f"raylet process failed to start: {err[-2000:]}")
        info = json.loads(line)
        return proc, tuple(info["address"])

    def add_node(self, *, num_cpus: float = 4, num_gpus: float = 0,
                 resources: dict | None = None, external: bool = False,
                 store_capacity: int = 256 << 20,
                 labels: dict | None = None,
                 infeasible_timeout_s: float = 10.0) -> NodeHandle:
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        if resources:
            res.update({k: float(v) for k, v in resources.items()})
        node_id = NodeID.from_random().hex()
        labels = dict(labels or {})
        with self._lock:
            if self._head_id is None:
                labels.setdefault("head", True)
        if external:
            cfg = {"node_id": node_id, "gcs_address": list(self.gcs_address),
                   "resources": res, "store_capacity": store_capacity,
                   "labels": labels,
                   "infeasible_timeout_s": infeasible_timeout_s}
            err_path = os.path.join(self._log_dir,
                                    f"raylet-{node_id[:12]}.err")
            proc, address = self._spawn_raylet_proc(cfg, err_path)
            handle = NodeHandle(node_id, proc=proc, address=address,
                                spawn_cfg=cfg, err_path=err_path)
        else:
            raylet = Raylet(node_id=node_id, gcs_address=self.gcs_address,
                            resources=res, store_capacity=store_capacity,
                            labels=labels,
                            infeasible_timeout_s=infeasible_timeout_s
                            ).start()
            handle = NodeHandle(node_id, raylet=raylet,
                                address=raylet.address)
        with self._lock:
            self.nodes[node_id] = handle
            if self._head_id is None:
                self._head_id = node_id
        return handle

    def respawn_node(self, handle: NodeHandle) -> NodeHandle:
        """Revive a crashed EXTERNAL raylet under the same node id. The
        fresh process re-registers with the GCS on its first heartbeat
        (registration replay), so to the scheduler the node comes back
        rather than a new one appearing."""
        if handle.spawn_cfg is None:
            raise RuntimeError("respawn_node only revives external nodes")
        if handle.proc is not None and handle.proc.poll() is None:
            handle.proc.kill()
        if handle.proc is not None:
            handle.proc.wait(timeout=10)
        proc, address = self._spawn_raylet_proc(handle.spawn_cfg,
                                                handle.err_path)
        handle.proc = proc
        handle.address = address
        handle.restart_count += 1
        return handle

    def remove_node(self, handle: NodeHandle, *, graceful: bool = False):
        """Kill a node (chaos path: non-graceful = SIGKILL, heartbeat
        timeout detection; reference: NodeKillerActor test_utils.py:1401)."""
        with self._lock:
            handle.removed = True
            self.nodes.pop(handle.node_id, None)
        if handle.proc is not None:
            if graceful:
                handle.proc.terminate()
            else:
                handle.proc.kill()
            handle.proc.wait(timeout=10)
        elif handle.raylet is not None:
            handle.raylet.stop()
        if graceful:
            try:
                from ray_tpu_torch.runtime.rpc import ConnectionLost, RpcClient
                c = RpcClient(self.gcs_address)
                try:
                    c.call("drain_node", node_id=handle.node_id)
                finally:
                    c.close()
            except (OSError, ConnectionLost, TimeoutError):
                pass  # GCS already gone: nothing left to drain from

    # -- supervisor (nanny) --------------------------------------------

    def start_supervisor(self, poll_s: float = 0.25):
        """Watch external raylet processes (and an external
        fault-tolerant GCS) and respawn any that die outside
        ``remove_node``. Records one ``crash_events`` entry per repaired
        death; ``recovered_at - detected_at`` is the respawn MTTR."""
        if self._supervisor is not None:
            return
        self._supervise = True
        self._supervisor = threading.Thread(
            target=self._supervise_loop, args=(max(0.05, poll_s),),
            name="cluster-supervisor", daemon=True)
        self._supervisor.start()

    def stop_supervisor(self):
        self._supervise = False
        t, self._supervisor = self._supervisor, None
        if t is not None:
            t.join(timeout=5)

    def _supervise_loop(self, poll_s: float):
        while self._supervise:
            with self._lock:
                handles = [h for h in self.nodes.values()
                           if h.proc is not None and not h.removed]
            for h in handles:
                if not self._supervise:
                    return
                if h.proc.poll() is None:
                    continue
                detected = time.time()
                with self._lock:
                    # deliberate remove raced the poll: not a crash
                    if h.removed or h.node_id not in self.nodes:
                        continue
                words = _last_words(h.err_path)
                try:
                    self.respawn_node(h)
                except (RuntimeError, OSError) as e:
                    words.setdefault("last_words", []).append(
                        f"respawn failed: {e!r}")
                self.crash_events.append({
                    "class": "raylet", "node_id": h.node_id,
                    "detected_at": detected, "recovered_at": time.time(),
                    "restart_count": h.restart_count,
                    "crash_point": words.get("crash_point"),
                    "last_words": words.get("last_words", [])})
            if (self._supervise and self._gcs_proc is not None
                    and self._gcs_proc.poll() is not None
                    and self._gcs_persist_dir is not None):
                detected = time.time()
                words = _last_words(self._gcs_err_path)
                self._gcs_proc = None
                try:
                    self.restart_gcs()
                except (RuntimeError, OSError) as e:
                    words.setdefault("last_words", []).append(
                        f"restart failed: {e!r}")
                self.crash_events.append({
                    "class": "gcs", "node_id": None,
                    "detected_at": detected, "recovered_at": time.time(),
                    "restart_count": self.gcs_restart_count,
                    "crash_point": words.get("crash_point"),
                    "last_words": words.get("last_words", [])})
            time.sleep(poll_s)

    def wait_for_nodes(self, n: int, timeout: float = 10.0):
        from ray_tpu_torch.runtime.rpc import RpcClient
        client = RpcClient(self.gcs_address)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                nodes = client.call("get_nodes", alive_only=True)
                if len(nodes) >= n:
                    return
                time.sleep(0.05)
            raise TimeoutError(f"cluster did not reach {n} nodes")
        finally:
            client.close()

    def shutdown(self):
        self.stop_supervisor()
        for handle in list(self.nodes.values()):
            self.remove_node(handle, graceful=True)
        if self._gcs_proc is not None:
            self._gcs_proc.terminate()
            try:
                self._gcs_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._gcs_proc.kill()
        if self.gcs is not None:
            self.gcs.stop()
        import shutil

        shutil.rmtree(self._log_dir, ignore_errors=True)
        if self._owns_persist_dir and self._gcs_persist_dir:
            shutil.rmtree(self._gcs_persist_dir, ignore_errors=True)


def _service_env() -> dict:
    """Environment of a GCS or raylet process: this process's, with the
    worker PYTHONPATH (the port's package root and this process's
    ``sys.path``) so its workers import what the driver can."""
    from ray_tpu_torch.runtime.worker_pool import _worker_pythonpath

    env = dict(os.environ)
    env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
    return env


def _read_tail(path: str | None, nbytes: int = 4096) -> str:
    if not path:
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def _last_words(path: str | None) -> dict:
    from ray_tpu_torch.runtime.worker_pool import _last_words as harvest
    return harvest(path)
