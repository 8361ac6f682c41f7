"""Runtime environments: the worker-cache key.

Port of ``env_key`` from ``ray_tpu/runtime_env.py``. Workers are cached
per runtime-env key, as the reference's (language, runtime_env)-keyed
worker pool does (``worker_pool.cc``). The port runs every worker in the
empty environment, whose key is ``""``: a non-empty ``runtime_env``
(env vars, working dirs, py_modules, pip, conda, containers) is refused
at submission (``api._refuse_runtime_env``) until a later slice.
"""

from __future__ import annotations

import hashlib
import json


def env_key(runtime_env: dict | None) -> str:
    """Stable identity of a runtime env — the worker-cache key."""
    if not runtime_env:
        return ""
    return hashlib.sha256(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:16]
