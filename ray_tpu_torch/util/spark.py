"""Ray-on-Spark launcher: start a ray_tpu_torch cluster on a Spark
cluster's executors (reference: ``python/ray/util/spark/cluster_init.py`` —
``setup_ray_cluster``/``shutdown_ray_cluster``/``MAX_NUM_WORKER_NODES``).

Shape follows the reference: the head (GCS + head raylet) starts on the
Spark DRIVER; each worker node runs as a long-lived barrier-mode Spark
task pinned to one executor, started with the port's own CLI
(``python -m ray_tpu_torch.scripts.cli start --address``) and torn down
when the background Spark job is cancelled.

Without pyspark every entry point raises a clear ImportError at call
time (the module imports without it), and the executor-side launch
command is factored out (``_worker_start_cmd``) so the launch protocol
is unit-testable without Spark."""

from __future__ import annotations

import os
import sys

# reference: cluster_init.py:46 — "use every executor" sentinel
MAX_NUM_WORKER_NODES = -1

_active: dict = {}


def _require_pyspark():
    try:
        import pyspark  # noqa: F401

        return pyspark
    except ImportError as e:
        raise ImportError(
            "ray_tpu_torch.util.spark requires pyspark, which is not "
            "installed: install pyspark, or start clusters with "
            "ray_tpu_torch.cluster_utils.Cluster or `ray-tpu-torch start` "
            "directly"
        ) from e


def _worker_start_cmd(gcs_address: tuple, num_cpus: int,
                      num_gpus: int = 0) -> list[str]:
    """The executor-side worker-node launch command (one per Spark
    barrier task). Factored for tests: the protocol (connect a raylet to
    the driver-hosted GCS) is what Ray-on-Spark is. The port's ``start``
    always stays in the foreground until stopped, so the command carries
    no ``--block`` (JAX's does, and its ``start`` refuses the flag)."""
    host, port = gcs_address
    return [
        sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
        "--address", f"{host}:{port}",
        "--num-cpus", str(num_cpus),
        "--num-gpus", str(num_gpus),
    ]


def setup_ray_cluster(*, num_worker_nodes: int,
                      num_cpus_per_node: int | None = None,
                      num_gpus_per_node: int = 0,
                      spark=None) -> str:
    """Start a ray_tpu_torch cluster over the active Spark session's
    executors (reference: setup_ray_cluster, cluster_init.py:803).
    Returns the GCS address ``host:port``; pass it to
    ``ray_tpu_torch.init(address=...)``.

    ``num_worker_nodes=MAX_NUM_WORKER_NODES`` uses every executor."""
    _require_pyspark()
    from pyspark.sql import SparkSession

    spark = spark or SparkSession.getActiveSession()
    if spark is None:
        raise RuntimeError("no active SparkSession; create one first")
    sc = spark.sparkContext
    if num_worker_nodes == MAX_NUM_WORKER_NODES:
        num_worker_nodes = max(
            1, int(sc.getConf().get("spark.executor.instances", "1")))
    num_cpus = num_cpus_per_node or int(
        sc.getConf().get("spark.executor.cores", "1"))

    from ray_tpu_torch.cluster_utils import Cluster

    head = Cluster(external_gcs=True)
    head.add_node(num_cpus=0, external=True)   # head: control plane only
    gcs_addr = head.gcs_address
    cmd = _worker_start_cmd(gcs_addr, num_cpus, num_gpus_per_node)

    def _run_worker(_):
        import subprocess

        from pyspark import BarrierTaskContext

        ctx = BarrierTaskContext.get()
        ctx.barrier()   # all worker nodes start together
        subprocess.run(cmd, check=False)
        return []

    # barrier-mode background job: one long-lived task per worker node
    # (reference: _start_ray_worker_nodes' spark job). Cancellation via
    # the job group is the shutdown path.
    import threading

    rdd = sc.parallelize(range(num_worker_nodes), num_worker_nodes)

    def _submit():
        sc.setJobGroup("ray_tpu_torch-on-spark",
                       "ray_tpu_torch worker nodes",
                       interruptOnCancel=True)
        rdd.barrier().mapPartitions(_run_worker).collect()

    job = threading.Thread(target=_submit, daemon=True,
                           name="ray_tpu_torch-spark-workers")
    job.start()
    addr = f"{gcs_addr[0]}:{gcs_addr[1]}"
    _active[addr] = (head, sc)
    os.environ["RAY_TPU_TORCH_ADDRESS"] = addr
    return addr


def shutdown_ray_cluster() -> None:
    """Tear down the Spark-hosted cluster (reference:
    shutdown_ray_cluster): cancel the worker-node job group, stop the
    driver-side head."""
    _require_pyspark()
    while _active:
        addr, (head, sc) = _active.popitem()
        try:
            sc.cancelJobGroup("ray_tpu_torch-on-spark")
        except Exception:  # noqa: BLE001
            pass
        head.shutdown()
    os.environ.pop("RAY_TPU_TORCH_ADDRESS", None)
