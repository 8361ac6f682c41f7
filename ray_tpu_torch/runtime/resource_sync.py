"""Versioned resource-view sync between raylets and the GCS.

A copy of ``ray_tpu/runtime/resource_sync.py``.

Reference analog: ``src/ray/common/ray_syncer/ray_syncer.h:86`` — the
reference syncs versioned RESOURCE_VIEW messages over bidirectional
streams so the control plane's scheduling view tracks node state at RPC
latency. Round 3 shipped whole-snapshot heartbeats instead (0.5s
period): every spillback/pick_node decision ran on a view up to one
heartbeat stale, and the payload was O(resources) per beat regardless
of change.

This module is the equivalent:

- every local resource mutation (lease grant/release, task dispatch,
  completion) bumps a VERSION and wakes a debounced pusher thread that
  sends ``resource_update(node_id, version, available)`` to the GCS
  within ``push_delay_s`` — staleness is bounded by RPC latency + the
  debounce, not the heartbeat period;
- heartbeats carry only the version number (payload O(1)); the GCS
  replies ``need_resources`` when its stored version lags (first beat,
  or a GCS restart lost the view), triggering one full push — the
  resync path;
- versions are monotonic per raylet incarnation, so out-of-order
  updates (a slow push racing a newer one) are dropped by the GCS.
"""

from __future__ import annotations

import threading


class ResourceSyncer:
    """Raylet-side half: version tracking + the debounced pusher."""

    def __init__(self, node, snapshot_fn, *, load_fn=None,
                 push_delay_s: float = 0.01):
        self._node = node
        self._snapshot = snapshot_fn        # () -> dict available
        self._load = load_fn or (lambda: 0)  # () -> ready-queue depth
        self._push_delay = push_delay_s
        self._cv = threading.Condition()
        self._version = 0
        self._pushed_version = 0
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._push_loop,
                                        daemon=True,
                                        name="resource-syncer")
        self._thread.start()

    def mark_changed(self):
        """A local resource mutation happened: bump the version and wake
        the pusher (called from the scheduler's acquire/release paths —
        must be cheap and never block on the network)."""
        with self._cv:
            self._version += 1
            self._cv.notify()

    @property
    def version(self) -> int:
        with self._cv:
            return self._version

    @property
    def pushed_version(self) -> int:
        """The last version KNOWN DELIVERED — what heartbeats should
        report. Reporting the live version instead makes every beat on
        a busy node look like a lost push (the debounced pusher is
        always slightly behind) and triggers spurious full resyncs."""
        with self._cv:
            return max(self._pushed_version, 0)

    def force_push(self):
        """GCS requested a resync (heartbeat replied need_resources)."""
        with self._cv:
            self._pushed_version = -1
            self._cv.notify()

    def _push_loop(self):
        import time

        node = self._node
        while not node._stopping:
            with self._cv:
                while (self._pushed_version >= self._version
                       and not node._stopping):
                    self._cv.wait(timeout=1.0)
                if node._stopping:
                    return
            # debounce: a dispatch burst (N grants in a few ms) becomes
            # one push carrying the latest view
            time.sleep(self._push_delay)
            with self._cv:
                version = self._version
            try:
                with node._gcs_lock:
                    node._gcs.call("resource_update",
                                   node_id=node.node_id,
                                   version=version,
                                   available=self._snapshot(),
                                   load=self._load())
                with self._cv:
                    self._pushed_version = max(self._pushed_version,
                                               version)
            except Exception:  # noqa: BLE001 - GCS down: the heartbeat's
                # version mismatch re-triggers the push after recovery
                time.sleep(0.2)
