"""ray_tpu_torch.util: the port of ``ray_tpu.util`` (reference: ray.util).

Lazy re-exports (PEP 562), as JAX's: the helpers here call
``ray_tpu_torch.remote`` at import time, so this package's ``__init__``
imports none of them until a name is asked for. ``metrics`` (which the
runtime's own modules import for hot-path instrumentation) and ``state``
are submodules, loaded on first attribute access too; ``__all__`` stays
JAX's.
"""

__all__ = [
    "ActorPool",
    "ParallelIterator",
    "Queue",
    "from_items",
    "from_range",
]

_HOMES = {
    "ActorPool": "ray_tpu_torch.util.actor_pool",
    "ParallelIterator": "ray_tpu_torch.util.iter",
    "from_items": "ray_tpu_torch.util.iter",
    "from_range": "ray_tpu_torch.util.iter",
    "Queue": "ray_tpu_torch.util.queue",
}
_SUBMODULES = ("metrics", "state")


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(home), name)
