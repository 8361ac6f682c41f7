"""The flags the port's runtime, Serve and engines read.

A copy of the parts of ``ray_tpu/utils/config.py`` that the in-process
runtime, the Serve plane and the serve engines read, with the same names,
defaults and environment overrides (``RAY_TPU_<NAME>``), and the same
process-wide instance: ``init(system_config=...)`` resets it and applies
the overrides (``reset_config``, ``Config.apply_overrides``).
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
    # --- in-process runtime ---
    # Per-process counts of live ObjectRefs; a value whose count drops to
    # zero is freed from the store.
    ref_counting_enabled: bool = True
    # Threads of the task pool (0 = the CPU resource).
    num_workers: int = 0

    # --- serve engines ---
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

    # --- serve plane ---
    # Prefix-affinity routing: handles score replicas by the longest
    # cached prefix in their published page-hash digests and fall back to
    # power-of-two-choices when nothing matches.
    serve_prefix_routing_enabled: bool = True
    # Min interval between a replica's prefix-digest publishes.
    serve_digest_publish_interval_s: float = 0.2
    # A digest older than this is ignored by the router.
    serve_digest_ttl_s: float = 5.0
    # The controller pings every replica on this period and replaces ones
    # that stop answering.
    serve_health_probing_enabled: bool = True
    serve_health_probe_period_s: float = 0.5
    serve_health_probe_timeout_s: float = 1.0
    # Consecutive probe timeouts before a replica is declared dead (a
    # typed actor-death error is immediate).
    serve_health_probe_failures: int = 3
    # Scale-down grace: a draining replica keeps serving its in-flight
    # requests up to this long before the controller kills it anyway.
    serve_drain_timeout_s: float = 5.0

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name,
                                                getattr(self, f.name)))

    def apply_overrides(self, overrides: dict | None):
        if not overrides:
            return self
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown config flag: {k!r}")
            setattr(self, k, v)
        return self


_global_config: Config | None = None


def get_config() -> Config:
    """The process's flags, read from the environment at first use (or at
    the last ``reset_config``)."""
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def reset_config():
    global _global_config
    _global_config = None
