"""The serve flags the port's engines read.

A copy of the serve-engine part of ``ray_tpu/utils/config.py``, with the
same names, defaults and environment overrides (``RAY_TPU_<NAME>``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    ty = type(default)
    if ty is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw


@dataclass
class Config:
    # Steady-state decode steps per dispatched chunk: large chunks cut
    # per-dispatch overhead, small chunks bound how long a new request
    # waits behind in-flight work.
    serve_decode_chunk: int = 16
    # Short chunk used while admissions are imminent (_use_drain_chunk).
    serve_drain_chunk: int = 8
    # KV page size (tokens) for the paged engine.
    serve_kv_page_size: int = 128
    # Prefix cache on shared prompt prefixes (chat/system prompts).
    serve_prefix_cache_enabled: bool = True
    # Continuous admission: the engine loop opens a timed admission
    # window between decode-chunk dispatches, so a request arriving
    # mid-chunk prefills behind ONE in-flight chunk.
    serve_continuous_admission: bool = True
    # Fraction of the average chunk period the admission window may wait.
    serve_admission_window_frac: float = 0.75
    # Read by the prefix-affinity router of the JAX package's serve plane;
    # kept so the two flag sets stay in step.
    serve_prefix_routing_enabled: bool = True
    serve_digest_publish_interval_s: float = 0.2

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name,
                                                getattr(self, f.name)))


def get_config() -> Config:
    """The flags as the environment sets them now."""
    return Config()
