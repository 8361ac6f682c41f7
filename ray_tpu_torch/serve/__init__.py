"""ray_tpu_torch.serve: model serving on the port's in-process runtime.

Port of ``ray_tpu.serve`` (reference: Ray Serve). The engines live in
``serve/llm.py`` and ``serve/paged_llm.py``; ``LLMDeployment`` is the
deployment body that hosts one. Waiting for the next slice:
``ingress``, ``grpc_call`` and ``start_grpc_proxy`` (``serve/ingress.py``),
``apply_config`` and ``apply_config_file`` (``serve/schema.py``, which
reads YAML).
"""

from ray_tpu_torch.serve.api import (
    batch,
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start_http_proxy,
    status,
)
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "AutoscalingConfig",
    "DeploymentConfig",
    "DeploymentHandle",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "shutdown",
    "start_http_proxy",
    "status",
]
