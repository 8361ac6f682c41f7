"""ray_tpu_torch.serve: model serving on the port's in-process runtime.

Port of ``ray_tpu.serve`` (reference: Ray Serve). The engines live in
``serve/llm.py`` and ``serve/paged_llm.py``; ``LLMDeployment`` is the
deployment body that hosts one. ``ingress`` mounts an ASGI app on a
deployment and ``start_grpc_proxy``/``grpc_call`` are the gRPC ingress
(``serve/ingress.py``); ``apply_config``/``apply_config_file`` deploy a
declarative config (``serve/schema.py``). Every name of ``ray_tpu.serve``
is here.
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
from ray_tpu_torch.serve.ingress import grpc_call, ingress, start_grpc_proxy
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.schema import apply_config, apply_config_file

__all__ = [
    "AutoscalingConfig",
    "DeploymentConfig",
    "DeploymentHandle",
    "apply_config",
    "apply_config_file",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "grpc_call",
    "ingress",
    "multiplexed",
    "run",
    "shutdown",
    "start_grpc_proxy",
    "start_http_proxy",
    "status",
]
