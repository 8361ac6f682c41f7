"""The process's annex registry: small payloads published by one part of
the process and shipped, or read, by another.

Port of the annex registry of ``ray_tpu/runtime/metrics_plane.py:40-123``
(``set_annex``, ``set_annex_provider``, ``local_annexes`` and the
pusher's versioned snapshot). It is the one registry of the process: a
serve replica's engine publishes its prefix-cache digest here
(``serve/paged_llm.py``), the log plane its task segments
(``runtime/log_plane.py``), and the process's metrics pusher
(``runtime/metrics_plane.py``) ships the current set on its frames to
the GCS store, where ``util.state.cluster_metric_annexes`` reads every
process's set. In the in-process runtime every replica shares this
registry and the state API reads it directly. Same best-effort contract
as the JAX package: a lost annex costs routing fidelity, never
correctness.
"""

from __future__ import annotations

import threading
import time

_annex_lock = threading.Lock()
_annexes: dict[str, tuple[float, object]] = {}
# bumped on every publish/retract: the pusher re-ships the set when it
# moved since its last successful push
_annex_version = 0
# annex PROVIDERS: key -> zero-arg callable evaluated at snapshot time,
# for payloads that must reflect live state rather than a value frozen
# at publish time. A provider returning None skips the key this round;
# exceptions are swallowed (best-effort, same contract as the frames
# they ride).
_annex_providers: dict[str, object] = {}


def set_annex(key: str, payload) -> None:
    """Publish (payload) or retract (None) one annex under ``key``."""
    global _annex_version
    with _annex_lock:
        if payload is None:
            _annexes.pop(key, None)
        else:
            _annexes[key] = (time.time(), payload)
        _annex_version += 1


def set_annex_provider(key: str, fn) -> None:
    """Register (fn) or retract (None) a live annex under ``key``:
    ``fn()`` is called on every snapshot and its return value ships as
    the payload. Providers re-ship on the pusher's periodic re-stamp
    cadence even when no static annex changed."""
    global _annex_version
    with _annex_lock:
        if fn is None:
            _annex_providers.pop(key, None)
        else:
            _annex_providers[key] = fn
        _annex_version += 1


def _evaluate(providers: list, out: dict, wrap):
    # providers run OUTSIDE the annex lock: they take their own locks
    # and must not order against annex publication
    for key, fn in providers:
        try:
            payload = fn()
        except Exception:  # noqa: BLE001 - provider is best-effort
            continue
        if payload is not None:
            out[key] = wrap(payload)
    return out


def local_annexes() -> dict[str, tuple[float, object]]:
    """{key: (ts, payload)} snapshot of this process's annexes, providers
    included (evaluated now)."""
    with _annex_lock:
        out = dict(_annexes)
        providers = list(_annex_providers.items())
    now = time.time()
    return _evaluate(providers, out, lambda p: (now, p))


def annex_snapshot() -> tuple[int, dict]:
    """(version, {key: payload}): what the pusher ships, providers
    evaluated now."""
    with _annex_lock:
        ver = _annex_version
        out = {k: v[1] for k, v in _annexes.items()}
        providers = list(_annex_providers.items())
    return ver, _evaluate(providers, out, lambda p: p)
