"""Runtime context (reference: ``python/ray/runtime_context.py:444,16`` —
``ray.get_runtime_context()``).

Port of ``ray_tpu/runtime_context.py`` for the in-process runtime, where
every task and actor runs in the driver's process and namespace. The task
id (``get_task_id``, from the JAX package's log plane), the worker's own
namespace and the GCS address wait for the cluster runtime.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RuntimeContext:
    node_id: str
    worker_id: str
    job_id: str
    namespace: str = ""

    def get_node_id(self) -> str:
        return self.node_id

    def get_worker_id(self) -> str:
        return self.worker_id

    def get_job_id(self) -> str:
        return self.job_id


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.runtime import core as _core

    if not _core.is_initialized():
        return RuntimeContext(node_id="", worker_id="driver", job_id="")
    rt = _core.get_runtime()
    return RuntimeContext(node_id=rt.node_id.hex(), worker_id="driver",
                          job_id=rt.job_id.hex(), namespace=rt.namespace)
