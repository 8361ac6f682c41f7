"""ray_tpu_torch.experimental: the port of ``ray_tpu.experimental``.

``free`` (explicit object release), the internal KV store and
``tqdm_ray`` (progress bars aggregated by a named actor), with JAX's
names and semantics.
"""

from ray_tpu_torch.experimental import tqdm_ray
from ray_tpu_torch.experimental.free import free
from ray_tpu_torch.experimental.internal_kv import (internal_kv_del,
                                                    internal_kv_get,
                                                    internal_kv_list,
                                                    internal_kv_put)

__all__ = [
    "free",
    "internal_kv_del",
    "internal_kv_get",
    "internal_kv_list",
    "internal_kv_put",
    "tqdm_ray",
]
