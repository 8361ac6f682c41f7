"""Internal KV store API.

Reference analog: ``python/ray/experimental/internal_kv.py``: thin
functions over the GCS KV (``GcsKvManager``). On a cluster they call the
GCS's ``kv_*`` RPCs (namespace ``internal_kv``); on the in-process runtime
they use a table of this process with the same semantics (namespaced
bytes keys). A cluster worker that has not attached yet resolves its
implicit runtime first, as the task API does, so its reads hit the GCS.
"""

from __future__ import annotations

import os
import threading

from ray_tpu_torch.runtime import core as _core

_NS = "internal_kv"
_local_kv: dict[str, bytes] = {}
_lock = threading.Lock()


def _gcs():
    """The GCS client of the runtime this process is attached to, or None
    for the in-process runtime (and for no runtime at all)."""
    if not _core.is_initialized():
        if not os.environ.get("RAY_TPU_TORCH_GCS_HOST"):
            return None
        from ray_tpu_torch.api import _runtime

        _runtime()   # inside a cluster worker: attach to its node
    return getattr(_core.get_runtime(), "_gcs", None)


def _as_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def internal_kv_put(key, value, overwrite: bool = True) -> bool:
    key = _as_str(key)
    value = value if isinstance(value, bytes) else str(value).encode()
    gcs = _gcs()
    if gcs is not None:
        reply = gcs.call("kv_put", ns=_NS, key=key, value=value,
                         overwrite=overwrite)
        if isinstance(reply, dict):
            return bool(reply.get("ok"))
        return bool(reply)
    with _lock:
        if not overwrite and key in _local_kv:
            return False
        _local_kv[key] = value
        return True


def internal_kv_get(key) -> bytes | None:
    key = _as_str(key)
    gcs = _gcs()
    if gcs is not None:
        return gcs.call("kv_get", ns=_NS, key=key)
    with _lock:
        return _local_kv.get(key)


def internal_kv_del(key) -> bool:
    key = _as_str(key)
    gcs = _gcs()
    if gcs is not None:
        return bool(gcs.call("kv_del", ns=_NS, key=key).get("ok"))
    with _lock:
        return _local_kv.pop(key, None) is not None


def internal_kv_list(prefix="") -> list[str]:
    prefix = _as_str(prefix)
    gcs = _gcs()
    if gcs is not None:
        return gcs.call("kv_keys", ns=_NS, prefix=prefix)
    with _lock:
        return [k for k in _local_kv if k.startswith(prefix)]
