"""Multi-node-on-one-host cluster.

Port of ``ray_tpu/cluster_utils.py``; ``add_node(num_gpus=...)`` is JAX's
``num_tpus=`` renamed, with its default (0) kept. Reference analog:
``python/ray/cluster_utils.py:108`` — the workhorse for distributed
tests: N raylets (+1 GCS) as local processes sharing one machine; node
failure = kill the raylet process.

The GCS and the head raylet run in-process (threads); added nodes run as
separate OS processes (``add_node(external=True)``) so ``remove_node``
is a real process kill. With ``external_gcs=True`` the control plane is
its own process as well.
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
                 proc: subprocess.Popen | None = None, address=None):
        self.node_id = node_id
        self.raylet = raylet
        self.proc = proc
        self.address = address


class Cluster:
    """``Cluster()`` → ``add_node(num_cpus=...)`` → drive via
    ``ray_tpu_torch.init(address=cluster.gcs_address)``."""

    def __init__(self, *, heartbeat_timeout_s: float = 3.0,
                 external_gcs: bool = False):
        import tempfile

        self._hb_timeout = heartbeat_timeout_s
        self._gcs_proc = None
        self._log_dir = tempfile.mkdtemp(prefix="rtt_cluster_")
        if external_gcs:
            # the control plane as its OWN process (the reference's
            # gcs_server is one too): its RPC handling must not share
            # the driver's GIL — the hot resource in submit benchmarks.
            self.gcs = None
            self.gcs_address = self._spawn_gcs_proc()
        else:
            self.gcs = GcsServer(
                heartbeat_timeout_s=heartbeat_timeout_s).start()
            self.gcs_address = self.gcs.address
        self.nodes: dict[str, NodeHandle] = {}
        self._head_id: str | None = None
        self._lock = threading.Lock()

    def _spawn_gcs_proc(self) -> tuple:
        cfg = {"heartbeat_timeout_s": self._hb_timeout}
        err_path = os.path.join(self._log_dir, "gcs.err")
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
            handle = NodeHandle(node_id, proc=proc, address=address)
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

    def remove_node(self, handle: NodeHandle, *, graceful: bool = False):
        """Kill a node (chaos path: non-graceful = SIGKILL, heartbeat
        timeout detection; reference: NodeKillerActor test_utils.py:1401)."""
        with self._lock:
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

