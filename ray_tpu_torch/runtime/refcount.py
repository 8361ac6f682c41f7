"""Object reference counting — the owner-side counter of the local runtime.

Port of the local-mode half of ``ray_tpu/runtime/refcount.py``
(reference: ``src/ray/core_worker/reference_count.h:61``). Every live
``ObjectRef`` instance in the process adds one to its object's count;
``__del__`` queues a death notice without taking the lock (a GC pass can
fire inside a locked section), and the runtime's poll loop drains the
notices and calls the release callback for each object whose count fell
to zero, which frees it from the store (``core.Runtime._on_ref_zero``).

The cluster protocol (batched flushes to the GCS, task pins, contains
edges, the memory plane's ownership table) waits for the cluster slice.
"""

from __future__ import annotations

import threading
from collections import deque


class RefCounter:
    """Process-local reference table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}       # oid hex -> live instances
        self._dead: deque = deque()             # oid hex death notices
        self._dirty: set[str] = set()           # count changed since poll
        # local-mode immediate release callback: called with the oid hex
        # when its count drops to zero
        self._local_release_cb = None

    # ------------------------------------------------------------------
    # instance tracking (ObjectRef hooks)
    # ------------------------------------------------------------------

    def on_created(self, oid_hex: str):
        with self._lock:
            c = self._counts.get(oid_hex, 0)
            self._counts[oid_hex] = c + 1
            if c == 0:
                self._dirty.add(oid_hex)

    def on_destroyed(self, oid_hex: str):
        # lock-free: __del__ may run mid-GC inside a locked section
        self._dead.append(oid_hex)

    def _drain_dead_locked(self):
        while True:
            try:
                oid_hex = self._dead.popleft()
            except IndexError:
                break
            c = self._counts.get(oid_hex, 0) - 1
            if c <= 0:
                self._counts.pop(oid_hex, None)
                self._dirty.add(oid_hex)
            else:
                self._counts[oid_hex] = c

    # ------------------------------------------------------------------
    # local mode (in-process runtime: release immediately)
    # ------------------------------------------------------------------

    def set_local_release(self, cb):
        """Install (or, with None, remove) the immediate-release callback.
        While set, zero-count transitions call ``cb(oid_hex)`` from the
        poll loop."""
        with self._lock:
            self._local_release_cb = cb
        if cb is not None:
            _activate()
        else:
            _deactivate()

    def poll_local(self):
        """Drain death notices and fire the release callback for oids
        that dropped to zero."""
        with self._lock:
            cb = self._local_release_cb
            if cb is None:
                return
            self._drain_dead_locked()
            zeroed = [h for h in self._dirty
                      if self._counts.get(h, 0) == 0]
            # positive transitions carry no local-mode action: clear all
            # so the dirty set stays bounded
            self._dirty.clear()
        for oid_hex in zeroed:
            try:
                cb(oid_hex)
            except Exception:  # noqa: BLE001 - release is best-effort
                pass

    def reset(self):
        """Forget all state (runtime shutdown / test isolation)."""
        with self._lock:
            self._counts.clear()
            self._dead.clear()
            self._dirty.clear()
            self._local_release_cb = None


# The process-global counter fed by ObjectRef lifecycle hooks.
global_counter = RefCounter()

# Tracking is armed only while a release callback is installed: refs made
# with no runtime draining the counter must not accumulate state. Refs
# constructed before activation are permanently untracked.
_active = False


def is_active() -> bool:
    return _active


def _activate():
    global _active
    _active = True


def _deactivate():
    global _active
    _active = False
