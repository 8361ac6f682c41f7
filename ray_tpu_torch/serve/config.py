"""Deployment configuration (reference: ``serve/config.py`` +
``serve/schema.py`` pydantic models, collapsed to dataclasses).

A copy of ``ray_tpu/serve/config.py``. ``policy="metrics"`` scales on
the metrics plane's windowed signals (``metrics_window_s``,
``upscale_queue_wait_s``, ``kv_upscale_occupancy``) and falls back to
the polled per-replica counts when the plane is dark; ``"polled"``
always polls.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    # -- the metrics-driven policy ------------------------------------
    policy: str = "metrics"
    metrics_window_s: float = 3.0
    upscale_queue_wait_s: float = 0.25
    kv_upscale_occupancy: float = 0.9


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    autoscaling: AutoscalingConfig | None = None
    user_config: dict = field(default_factory=dict)
    resources_per_replica: dict = field(default_factory=dict)
