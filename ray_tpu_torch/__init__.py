"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu.

A package of its own beside ``ray_tpu``: it imports ``torch`` and never
``jax``, and no module of ``ray_tpu``. Modules mirror ``ray_tpu``'s names
(``ray_tpu_torch.ops.attention`` <-> ``ray_tpu.ops.attention``). Entry
points run on the CUDA card unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise.

The core API (``init``, ``remote``, ``get``, ``put``, ``wait``, actors)
runs on the in-process runtime (``runtime/core.py``), or on a cluster of
the port's GCS and raylets (``init(address=)``), on which Serve
(``ray_tpu_torch.serve``) deploys its replicas; ``RuntimeEnv`` gives a
task or actor an environment of its own.
"""

from ray_tpu_torch.api import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.runtime.object_ref import ObjectRef
from ray_tpu_torch.runtime.streaming import ObjectRefGenerator
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch.runtime_env import RuntimeEnv
from ray_tpu_torch.utils import exceptions

__version__ = "0.1.0"

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "get_runtime_context",
    "cluster_resources",
    "available_resources",
    "ObjectRef",
    "ObjectRefGenerator",
    "RuntimeEnv",
    "exceptions",
    "__version__",
]
