"""The process's annex registry: small payloads published by one part of
the process and read by another.

Port of the annex registry of ``ray_tpu/runtime/metrics_plane.py:63-90``
(``set_annex``, ``set_annex_provider``, ``local_annexes``) and of the local
branch of ``ray_tpu/util/state.py:179-200`` (``cluster_metric_annexes``).
A serve replica's engine publishes its prefix-cache digest here
(``serve/paged_llm.py``); handles read every replica's digest here to route
a prompt to the replica that already holds its prefix
(``serve/prefix_router.py``). In the in-process runtime every replica
shares the one registry. The pusher that ships annexes on metrics frames,
and the GCS store that keeps them for other processes, wait for the
cluster slice. Same best-effort contract as the JAX package: a lost annex
costs routing fidelity, never correctness.
"""

from __future__ import annotations

import threading
import time

_annex_lock = threading.Lock()
_annexes: dict[str, tuple[float, object]] = {}
# annex PROVIDERS: key -> zero-arg callable evaluated at read time, for
# payloads that must reflect live state rather than a value frozen at
# publish time. A provider returning None skips the key; exceptions are
# swallowed.
_annex_providers: dict[str, object] = {}


def set_annex(key: str, payload) -> None:
    """Publish (payload) or retract (None) one annex under ``key``."""
    with _annex_lock:
        if payload is None:
            _annexes.pop(key, None)
        else:
            _annexes[key] = (time.time(), payload)


def set_annex_provider(key: str, fn) -> None:
    """Register (fn) or retract (None) a live annex under ``key``:
    ``fn()`` is called on every read and its return value is the
    payload."""
    with _annex_lock:
        if fn is None:
            _annex_providers.pop(key, None)
        else:
            _annex_providers[key] = fn


def local_annexes() -> dict[str, tuple[float, object]]:
    """{key: (ts, payload)} snapshot of this process's annexes, providers
    included (evaluated now)."""
    with _annex_lock:
        out = dict(_annexes)
        providers = list(_annex_providers.items())
    now = time.time()
    # providers run OUTSIDE the lock: they may take their own locks
    for key, fn in providers:
        try:
            payload = fn()
        except Exception:  # noqa: BLE001 - provider is best-effort
            continue
        if payload is not None:
            out[key] = (now, payload)
    return out


def cluster_metric_annexes(prefix: str = "",
                           max_age_s: float | None = None) -> list[dict]:
    """[{src, key, ts, payload}] annexes under ``prefix``, newest first
    (e.g. serve prefix-cache digests under ``serve/prefix_digest/``),
    those older than ``max_age_s`` left out."""
    now = time.time()
    items = [(k, ts, payload)
             for k, (ts, payload) in local_annexes().items()
             if k.startswith(prefix)
             and (max_age_s is None or now - ts <= max_age_s)]
    items.sort(key=lambda it: -it[1])
    return [{"src": "local", "key": k, "ts": ts, "payload": payload}
            for k, ts, payload in items]
