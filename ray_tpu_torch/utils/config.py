"""The flags the port's runtime, Serve and engines read.

A copy of the parts of ``ray_tpu/utils/config.py`` that the in-process
runtime, the cluster runtime (GCS, raylets, workers, the object store),
the Serve plane and the serve engines read, with the same names,
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

    # --- cluster runtime: object store ---
    # Objects smaller than this stay in the owner's in-process memory store.
    max_direct_call_object_size: int = 100 * 1024
    # Enable automatic spilling to disk under memory pressure.
    object_spilling_enabled: bool = True
    # Spill loop thresholds: start spilling above `high`, stop below `low`
    # (fractions of store capacity).
    object_spilling_high_fraction: float = 0.8
    object_spilling_low_fraction: float = 0.5
    # Directory for spilled object files ("" = a per-raylet temp dir).
    object_spilling_directory: str = ""
    # Node-to-node transfer chunk size, and the cap on bytes in flight
    # across all pulls as a fraction of the destination store's capacity.
    object_transfer_chunk_bytes: int = 5 << 20
    object_transfer_inflight_fraction: float = 0.25
    # Max ids per C call into the shm store (bounds the process-shared
    # mutex hold; ShmObjectStore.BATCH_WINDOW).
    store_batch_window: int = 4096

    # --- cluster runtime: memory monitor ---
    # Host memory-used fraction above which the raylet kills a worker to
    # relieve pressure. <= 0 disables.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 250
    # OOM kills draw from their own per-task budget.
    task_oom_retries: int = 3

    # --- cluster runtime: reference counting across processes ---
    # How often each process flushes its ref-count deltas.
    ref_flush_interval_s: float = 0.1
    # A client missing heartbeats this long is dead: its ref contributions
    # are dropped and its non-detached actors killed.
    client_timeout_s: float = 45.0
    # Grace before contains-edge releases propagate to inner objects.
    ref_release_grace_s: float = 0.5
    # Client-liveness heartbeat period (empty ref_update when idle).
    ref_heartbeat_interval_s: float = 5.0

    # --- cluster runtime: resource sync ---
    raylet_heartbeat_interval_s: float = 0.5
    # Debounce for event-driven resource pushes.
    resource_sync_push_delay_s: float = 0.01
    # Ready-queue depth beyond which a submitted task spills back through
    # the GCS view.
    scheduler_spillback_queue_depth: int = 32

    # --- cluster runtime: submission pipeline ---
    # Hard and soft caps on cached per-address actor-call clients.
    actor_client_cache_size: int = 8192
    actor_client_soft_cap: int = 256
    # Max unacked actor tasks per actor (outbox + frames in flight).
    actor_submit_window: int = 4096
    # Tasks packed per lease push RPC, in-flight push groups per lease,
    # and concurrent leases per resource shape.
    lease_group_size: int = 64
    lease_pipeline_depth: int = 2
    max_leases_per_shape: int = 64
    # Pickle-once function-export cache (driver), unpickle-once function
    # cache (worker).
    fn_export_cache_size: int = 512
    worker_fn_cache_size: int = 256
    # Linger before flushing a burst of put-pin / task-return reports.
    put_report_linger_s: float = 0.0005
    # Task events per GCS flush, and the staleness-bounding timer.
    task_event_batch_size: int = 128
    task_event_flush_interval_s: float = 2.0

    # --- cluster runtime: workers ---
    # How long a spawned worker may take to register before its actor
    # creation is failed.
    worker_register_timeout_s: float = 600.0
    # A granted lease whose owner never dials the worker's push port is
    # handed back after this long.
    lease_never_dialed_timeout_s: float = 10.0
    # Server-side parking window for a lease request.
    lease_block_s: float = 5.0

    # --- worker prestart / fork-server (runtime/prestart.py; env
    # overrides RAY_TPU_PRESTART_* — reference analog:
    # worker_pool.h:354 PrestartWorkers + idle-worker eviction knobs) ---
    # Master switch for the zygote fork path AND the demand-driven
    # prestart policy loop. Every miss (template cold, dead, containered
    # env) degrades to the plain Popen spawn.
    prestart_enabled: bool = True
    # Warm floor: forked-but-idle workers the policy loop keeps alive
    # for the default env even with an empty lease queue.
    prestart_min_workers: int = 0
    # Cumulative spawn requests for one env key before its template is
    # created. A template costs one interpreter start + the preload
    # imports; short-lived pools (a test cluster spawning a handful of
    # workers) never amortize that, so the first N-1 requests cold-spawn
    # without paying it. Burst workloads (actor fan-out) cross the
    # threshold within the first wave. An explicit warm() call,
    # prestart_min_workers > 0, or a key that once crossed the threshold
    # (respawn after template death) bypasses the gate.
    prestart_spawn_threshold: int = 8
    # Policy tick: how often lease-queue depth is sampled into a
    # prestart/evict decision.
    prestart_policy_interval_s: float = 0.25
    # Idle workers beyond the demand-predicted target older than this
    # are evicted (0 disables idle eviction; env-key mismatch eviction
    # at the cap is separate and always on).
    prestart_idle_timeout_s: float = 300.0
    # Fork request/reply deadline on the template control pipe; on
    # expiry the template is presumed wedged and killed (cold fallback).
    prestart_fork_timeout_s: float = 15.0
    # Spawn burst cap per policy tick (keeps one tick from forking the
    # whole max_workers budget at once on a deep queue).
    prestart_max_forks_per_tick: int = 8
    # Live zygote templates per node (LRU-evicted beyond this): one per
    # runtime-env key in active use.
    prestart_max_templates: int = 4

    # --- fault injection (runtime/fault_injection.py; env overrides
    # RAY_TPU_FAULT_INJECTION_* — the chaos tier's knobs) ---
    # Master switch: off = the plane is never consulted beyond one
    # boolean read per message.
    fault_injection_enabled: bool = False
    # Base seed for probabilistic rules (deterministic replay).
    fault_injection_seed: int = 0
    # Startup plan: inline JSON, or @/path/to/plan.json.
    fault_injection_plan: str = ""
    # Poll period for the GCS KV plan key (runtime open/heal switch).
    fault_injection_kv_poll_s: float = 0.25

    # --- cluster runtime: fault tolerance ---
    # Min seconds between lineage re-submissions of the same lost object.
    lineage_resubmit_grace_s: float = 60.0
    # Max lineage entries the owner keeps for reconstruction.
    lineage_max_entries: int = 100_000
    # Raylet-queue tasks with no location after this grace are presumed
    # lost in flight and resubmitted from lineage.
    task_pending_resubmit_grace_s: float = 20.0
    # Control-plane redial window, attempt cap (0 = window only), and the
    # exponential backoff with jitter between redials.
    rpc_redial_window_s: float = 10.0
    rpc_redial_max_attempts: int = 0
    rpc_backoff_initial_s: float = 0.05
    rpc_backoff_multiplier: float = 2.0
    rpc_backoff_max_s: float = 2.0
    rpc_backoff_jitter: float = 0.2

    # --- cluster runtime: actor control plane ---
    # Driver-side registration coalescer: linger, actors per frame, and
    # unacked registrations before create_actor blocks.
    actor_register_linger_s: float = 0.002
    actor_register_batch_size: int = 512
    actor_register_window: int = 8192
    # GCS placement executor threads, and placements per host_actors RPC.
    gcs_placement_pool_size: int = 8
    gcs_placement_batch_size: int = 256
    # Driver resolves actor locations from the GCS's pushed actor table.
    actor_pubsub_enabled: bool = True
    # GCS-side per-subscriber coalesce window for actor events.
    actor_pubsub_flush_s: float = 0.002
    # Wait on the pushed table before one get_actor poll, and the hard
    # deadline on resolving an actor's location.
    actor_resolve_fallback_s: float = 1.0
    actor_resolve_timeout_s: float = 60.0
    # Raylet-side linger coalescing actor_ready messages into one batch.
    actor_ready_linger_s: float = 0.002

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
