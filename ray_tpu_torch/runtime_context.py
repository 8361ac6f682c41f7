"""Runtime context (reference: ``python/ray/runtime_context.py:444,16`` —
``ray.get_runtime_context()``).

Port of ``ray_tpu/runtime_context.py``. In a cluster worker process the
node id, worker id and GCS address come from the worker's environment
(``RAY_TPU_TORCH_*``), and the namespace is the one of the task or actor
it executes. The task id (``get_task_id``, from the JAX package's log
plane) waits for the observability planes.
"""

from __future__ import annotations

import contextvars
import os
from dataclasses import dataclass

# Ambient namespace of the currently executing task/actor (reference:
# workers inherit the submitting job's namespace —
# ``_private/worker.py:1157``). Set by the worker around task execution;
# read by get_actor()/named-actor creation when the runtime has no
# explicit ``init(namespace=...)``.
_task_namespace: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "ray_tpu_torch_task_namespace", default=None)
# The namespace of the actor this worker process hosts: the ambient one of
# every thread the actor starts (a Serve controller's control loop creates
# the replicas, which must find the controller by name). The JAX package
# reads the context variable alone, so such a thread there falls back to
# its in-worker runtime's own job namespace.
_actor_namespace: str | None = None


def current_task_namespace() -> str | None:
    return _task_namespace.get() or _actor_namespace


def set_actor_namespace(ns: str | None):
    global _actor_namespace
    _actor_namespace = ns


def set_task_namespace(ns: str | None):
    """Returns a reset token."""
    return _task_namespace.set(ns)


def reset_task_namespace(token):
    _task_namespace.reset(token)


@dataclass
class RuntimeContext:
    node_id: str
    worker_id: str
    job_id: str
    gcs_address: str | None = None
    namespace: str = ""

    def get_node_id(self) -> str:
        return self.node_id

    def get_worker_id(self) -> str:
        return self.worker_id

    def get_job_id(self) -> str:
        return self.job_id


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.runtime import core as _core

    node_id = os.environ.get("RAY_TPU_TORCH_NODE_ID", "")
    worker_id = os.environ.get("RAY_TPU_TORCH_WORKER_ID", "driver")
    gcs = None
    if os.environ.get("RAY_TPU_TORCH_GCS_HOST"):
        gcs = (f"{os.environ['RAY_TPU_TORCH_GCS_HOST']}:"
               f"{os.environ['RAY_TPU_TORCH_GCS_PORT']}")
    job_id = ""
    if _core.is_initialized():
        rt = _core.get_runtime()
        node_id = node_id or getattr(rt, "node_id", "")
        if hasattr(node_id, "hex"):
            node_id = node_id.hex()
        job = getattr(rt, "job_id", None)
        job_id = job.hex() if hasattr(job, "hex") else str(job or "")
    ns = _task_namespace.get() or ""
    if not ns and _core.is_initialized():
        ns = getattr(_core.get_runtime(), "namespace", "") or ""
    return RuntimeContext(node_id=str(node_id), worker_id=worker_id,
                          job_id=job_id, gcs_address=gcs, namespace=ns)
