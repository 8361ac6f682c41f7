"""In-process object store with waiter notification.

Port of ``ray_tpu/runtime/object_store.py`` (reference: the in-process
``CoreWorkerMemoryStore``, ``store_provider/memory_store/memory_store.h``).
One tier holds everything in local mode. Error values are first-class
entries (as in the reference, where a task failure stores a
``RayTaskError`` under the return id), so ``get`` on a failed task's
output raises on every consumer. The JAX package's sampled latency
histograms belong to its metrics plane and are not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

from ray_tpu_torch.utils.exceptions import GetTimeoutError
from ray_tpu_torch.utils.ids import ObjectID


@dataclass
class _Entry:
    value: Any = None
    is_error: bool = False


class ObjectStore:
    """Thread-safe object table keyed by ObjectID."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[ObjectID, _Entry] = {}
        self._cv = threading.Condition(self._lock)
        # put-notification subscribers (dependency manager wiring)
        self._on_put: list[Callable[[ObjectID], None]] = []

    def subscribe_put(self, callback: Callable[[ObjectID], None]):
        with self._lock:
            self._on_put.append(callback)

    # --- writes ---

    def put(self, object_id: ObjectID, value: Any,
            is_error: bool = False) -> None:
        with self._cv:
            if object_id in self._objects:
                return  # objects are immutable; first write wins
            self._objects[object_id] = _Entry(value=value, is_error=is_error)
            self._cv.notify_all()
            callbacks = list(self._on_put)
        for cb in callbacks:
            cb(object_id)

    # --- reads ---

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get(self, object_ids: list[ObjectID], timeout: float | None = None) -> list[Any]:
        """Block until all ids are present; raise stored errors."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            for oid in object_ids:
                while oid not in self._objects:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(
                            f"Timed out waiting for object {oid.hex()}"
                        )
                    self._cv.wait(timeout=remaining)
            results = []
            for oid in object_ids:
                entry = self._objects[oid]
                if entry.is_error:
                    raise entry.value
                results.append(entry.value)
        return results

    def get_entry(self, object_id: ObjectID):
        """Non-blocking raw fetch: (found, value, is_error)."""
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                return False, None, False
            return True, entry.value, entry.is_error

    def wait(self, object_ids: list[ObjectID], num_returns: int,
             timeout: float | None = None) -> tuple[list[ObjectID], list[ObjectID]]:
        """Return (ready, not_ready) preserving input order (reference
        ``CoreWorker::Wait`` semantics — ``core_worker.cc:1509``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [oid for oid in object_ids if oid in self._objects]
                if len(ready) >= num_returns:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            ready_set = set(oid for oid in object_ids if oid in self._objects)
            ready = [oid for oid in object_ids if oid in ready_set][:num_returns]
            taken = set(ready)
            not_ready = [oid for oid in object_ids if oid not in taken]
            return ready, not_ready

    # --- lifecycle ---

    def free(self, object_ids: Iterable[ObjectID]):
        with self._cv:
            for oid in object_ids:
                self._objects.pop(oid, None)
