"""Usage stats: which libraries a process has used.

Port of ``record_library_usage`` from ``ray_tpu/_private/usage_stats.py``
(reference: ``python/ray/_private/usage/usage_lib.py``). Libraries record
their use at import (``data``, ``workflow``). Nothing reads the record
yet: the report, its counters and its opt-out come with the
observability plane.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_features: set[str] = set()


def record_library_usage(name: str) -> None:
    """Called by libraries at import or first use."""
    with _lock:
        _features.add(name)
