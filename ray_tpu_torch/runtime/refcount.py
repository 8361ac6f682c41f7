"""Object reference counting across processes — the process-local half.

Port of ``ray_tpu/runtime/refcount.py`` without the memory plane's
owned-object accounting (call sites, ownership snapshots: the
observability planes are a later slice). Reference analog:
``src/ray/core_worker/reference_count.h:61-115``, centralized to match the
GCS's centralized object directory (``runtime/gcs.py``):

- Every process (driver or worker) counts live ``ObjectRef`` instances per
  object id. Transitions (0→held, held→0) are flushed in batches to the
  GCS, which sums per-client holds, in-flight task pins, and
  contained-in edges; at zero, the GCS releases the primary copy on every
  node that registered a location.
- Submitting a task pins its argument objects under the task id; the
  executing worker releases the pin after the task finishes.
- Serializing a value that *contains* ObjectRefs records contains-edges:
  the outer object holds a reference on each inner one until the outer
  itself is released.
- The in-process runtime (``runtime/core.py``) drains the same counter
  through an immediate-release callback instead of a GCS flush.

``ObjectRef.__init__`` / ``__del__`` feed the process-global counter;
``__del__`` never takes the lock (a GC pass can fire inside a locked
section): death notices go through a lock-free deque drained on the next
flush.
"""

from __future__ import annotations

import threading
from collections import deque

class RefCounter:
    """Process-local reference table + pending flush state."""

    def __init__(self):
        self._lock = threading.Lock()
        # flusher wakeup: set by every lock-taking mutator so the flush
        # loops can BLOCK instead of polling (2,000 idle workers polling
        # at 5 Hz thrashed the host scheduler in the envelope run).
        # on_destroyed cannot signal (it runs in __del__, where taking
        # the Event's internal lock could deadlock mid-GC) — waiters
        # treat a non-empty dead deque as an immediate wakeup instead.
        self._signal = threading.Event()
        self._counts: dict[str, int] = {}       # oid hex -> live instances
        self._dead: deque = deque()             # oid hex death notices
        self._dirty: set[str] = set()           # count changed since flush
        self._flushed_held: set[str] = set()    # what the sink believes
        self._pins: list[tuple[str, list[str]]] = []   # (task_id, oids)
        self._pin_releases: list[str] = []              # task ids
        self._contains: list[tuple[str, list[str]]] = []
        # serialization capture: thread-local list appended to by
        # ObjectRef.__reduce__ while a capture scope is active
        self._tl = threading.local()
        # deserialize-tracking epoch: bumped on every on_created so
        # callers can detect "refs were constructed during this block"
        self._created_epoch = 0
        # local-mode immediate release callback (no flusher): called with
        # the oid hex when its count drops to zero
        self._local_release_cb = None
        # process-wide release hooks: called (outside the lock) with the
        # oids whose local count dropped to zero in a flush window —
        # the owner's in-process memory store evicts through this, no
        # matter which loop (driver or worker) drains the counter
        self._release_hooks: list = []
        # serialization hook: called with the oid hex of every ObjectRef
        # pickled in this process (any path — task args, puts, client
        # channels); the owner memory store promotes through it so a
        # ref shipped off-process always has a cluster-visible object
        self._serialize_hooks: list = []
    # ------------------------------------------------------------------
    # instance tracking (ObjectRef hooks)
    # ------------------------------------------------------------------

    def on_created(self, oid_hex: str):
        with self._lock:
            c = self._counts.get(oid_hex, 0)
            self._counts[oid_hex] = c + 1
            self._created_epoch += 1
            if c == 0:
                self._dirty.add(oid_hex)
                signal = True
            else:
                signal = False
        # is_set guard: Event.set() takes the Event's condition lock and
        # notifies even when already set — at 10k+ ref creations/s that
        # lock+notify per ref measurably stalls the submitting thread on
        # a small host (the flusher clears the flag only when it drains)
        if signal and not self._signal.is_set():
            self._signal.set()

    def on_destroyed(self, oid_hex: str):
        # lock-free: __del__ may run mid-GC inside a locked section
        self._dead.append(oid_hex)

    def _drain_dead_locked(self):
        zeroed = []
        while True:
            try:
                oid_hex = self._dead.popleft()
            except IndexError:
                break
            c = self._counts.get(oid_hex, 0) - 1
            if c <= 0:
                self._counts.pop(oid_hex, None)
                self._dirty.add(oid_hex)
                zeroed.append(oid_hex)
            else:
                self._counts[oid_hex] = c
        return zeroed

    # ------------------------------------------------------------------
    # serialization capture (contains-edges / nested task args)
    # ------------------------------------------------------------------

    class _Capture:
        def __init__(self, counter: "RefCounter"):
            self._counter = counter
            self.oids: set[str] = set()
            self._prev = None

        def add(self, oid_hex: str):
            self.oids.add(oid_hex)

        def __enter__(self):
            tl = self._counter._tl
            self._prev = getattr(tl, "capture", None)
            tl.capture = self
            return self

        def __exit__(self, *exc):
            self._counter._tl.capture = self._prev
            return False

    def capture(self) -> "RefCounter._Capture":
        """Scope that collects the oid of every ObjectRef serialized
        (``__reduce__``-ed) on this thread — puts record contains-edges,
        task submission records nested arg pins from it."""
        return RefCounter._Capture(self)

    def note_serialized(self, oid_hex: str):
        cap = getattr(self._tl, "capture", None)
        if cap is not None:
            cap.add(oid_hex)
        for hook in self._serialize_hooks:
            try:
                hook(oid_hex)
            except Exception:  # noqa: BLE001 - promotion is best-effort
                pass

    def add_serialize_hook(self, cb):
        self._serialize_hooks.append(cb)

    def remove_serialize_hook(self, cb):
        if cb in self._serialize_hooks:
            self._serialize_hooks.remove(cb)

    def add_release_hook(self, cb):
        self._release_hooks.append(cb)

    def remove_release_hook(self, cb):
        if cb in self._release_hooks:
            self._release_hooks.remove(cb)

    def count(self, oid_hex: str) -> int:
        """Current local instance count (GIL-atomic dict read)."""
        return self._counts.get(oid_hex, 0)

    def created_epoch(self) -> int:
        """Monotone counter of ObjectRef constructions in this process;
        callers compare before/after a deserialize to decide whether a
        synchronous flush is needed (borrower registration). Lock-free:
        a single int read is GIL-atomic, and callers only compare for
        inequality across their own critical section."""
        return self._created_epoch

    # ------------------------------------------------------------------
    # task pins + contains edges
    # ------------------------------------------------------------------

    def add_task_pins(self, task_id: str, oids: list[str]):
        if not oids:
            return
        with self._lock:
            self._pins.append((task_id, list(oids)))
        if not self._signal.is_set():
            self._signal.set()

    def release_task_pin(self, task_id: str):
        with self._lock:
            self._pin_releases.append(task_id)
        if not self._signal.is_set():
            self._signal.set()

    def add_contains(self, outer_hex: str, inner_hexes) -> None:
        inner = [h for h in inner_hexes if h != outer_hex]
        if not inner:
            return
        with self._lock:
            self._contains.append((outer_hex, inner))
        if not self._signal.is_set():
            self._signal.set()

    # ------------------------------------------------------------------
    # flushing
    # ------------------------------------------------------------------

    def take_flush(self) -> dict | None:
        """Snapshot-and-clear the pending state as a ``ref_update``
        payload; None when there is nothing to send. Adds are computed
        before removes so an add+remove of the same oid inside one
        window coalesces away."""
        with self._lock:
            self._drain_dead_locked()
            add, remove, transient = [], [], []
            for oid_hex in self._dirty:
                held = self._counts.get(oid_hex, 0) > 0
                was = oid_hex in self._flushed_held
                if held and not was:
                    add.append(oid_hex)
                    self._flushed_held.add(oid_hex)
                elif not held and was:
                    remove.append(oid_hex)
                    self._flushed_held.discard(oid_hex)
                elif not held and not was:
                    # held-and-dropped entirely WITHIN this flush window
                    # (put-get-del loops): the GCS never saw the hold, but
                    # it still needs the decrement event or the object is
                    # never considered for release
                    transient.append(oid_hex)
            self._dirty.clear()
            pins, self._pins = self._pins, []
            rel, self._pin_releases = self._pin_releases, []
            contains, self._contains = self._contains, []
        if (remove or transient) and self._release_hooks:
            dead = remove + transient
            for hook in self._release_hooks:
                try:
                    hook(dead)
                except Exception:  # noqa: BLE001 - eviction is best-effort
                    pass
        if not (add or remove or transient or pins or rel or contains):
            return None
        return {"add": add, "remove": remove, "transient": transient,
                "pins": pins, "pin_releases": rel, "contains": contains}

    def wait_pending(self, timeout: float) -> bool:
        """Block until flush-worthy state likely exists, or ``timeout``.
        Returns True when a flush should run now. Death notices can't
        signal (see ``_signal``), so a non-empty dead deque counts as an
        immediate wakeup — the subsequent ``take_flush`` drains it."""
        if self._dead:
            self._signal.clear()
            return True
        if self._signal.wait(timeout):
            self._signal.clear()
            return True
        return bool(self._dead)

    def force_resync(self):
        """The GCS reaped this client (heartbeat gap) and dropped every
        hold it believed we had: re-register the full held set on the
        next flush."""
        with self._lock:
            self._flushed_held.clear()
            for oid_hex, c in self._counts.items():
                if c > 0:
                    self._dirty.add(oid_hex)
        self._signal.set()

    def restore_flush(self, payload: dict):
        """Re-queue a flush whose send failed so the deltas are not
        lost (a lost add risks premature release; a lost remove leaks)."""
        with self._lock:
            for oid_hex in payload.get("add", ()):
                # still held? resend on the next flush
                self._flushed_held.discard(oid_hex)
                self._dirty.add(oid_hex)
            for oid_hex in payload.get("remove", ()):
                self._flushed_held.add(oid_hex)
                self._dirty.add(oid_hex)
            for oid_hex in payload.get("transient", ()):
                # not held, not believed held: re-dirty so the next flush
                # re-emits the transient decrement
                self._dirty.add(oid_hex)
            self._pins[:0] = payload.get("pins", ())
            self._pin_releases[:0] = payload.get("pin_releases", ())
            self._contains[:0] = payload.get("contains", ())
        self._signal.set()

    # ------------------------------------------------------------------
    # local mode (in-process runtime: release immediately, no RPC)
    # ------------------------------------------------------------------

    def set_local_release(self, cb):
        """Install an immediate-release callback (local-mode runtime).
        While set, zero-count transitions call ``cb(oid_hex)`` from the
        poll loop instead of accumulating flush state."""
        with self._lock:
            self._local_release_cb = cb
        if cb is not None:
            _activate()
        else:
            _deactivate()

    def poll_local(self):
        """Drain death notices and fire the local release callback for
        oids that dropped to zero (called from the local runtime's
        dispatcher / store hooks)."""
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
            self._flushed_held.clear()
            self._pins.clear()
            self._pin_releases.clear()
            self._contains.clear()
            self._local_release_cb = None
            self._release_hooks.clear()
            self._serialize_hooks.clear()


def flush_once(counter: "RefCounter", call, client_id: str, kind: str,
               force_heartbeat: bool = False) -> bool:
    """One flush round of the client protocol, shared by the driver and
    worker loops: take pending deltas, send ``ref_update``, requeue on
    failure, and re-sync the held set when the GCS says this client was
    reaped and resurrected. ``call(method, **kwargs)`` is the GCS RPC."""
    payload = counter.take_flush()
    if payload is None and not force_heartbeat:
        return False
    try:
        reply = call("ref_update", client_id=client_id, kind=kind,
                     **(payload or {}))
        if reply.get("resync"):
            counter.force_resync()
        return True
    except Exception:  # noqa: BLE001 - GCS unreachable: requeue deltas
        if payload:
            counter.restore_flush(payload)
        return False


# The process-global counter fed by ObjectRef lifecycle hooks.
global_counter = RefCounter()

# Tracking is armed only once a drain exists (a flusher claim or a
# local-mode release callback): processes that never drain (remote
# ray-client processes, ref_counting_enabled=False) must not accumulate
# per-ref state unboundedly. ObjectRefs constructed before activation
# are permanently untracked — safe: they simply never contribute.
_active = False


def is_active() -> bool:
    return _active


def _activate():
    global _active
    _active = True


def _deactivate():
    global _active
    _active = False

# One flush channel per process: a pool worker's Worker loop claims it
# first; a nested in-worker ClusterRuntime then piggybacks on it instead
# of double-reporting under a second client id (holder attribution must
# be consistent within a process).
_flusher_lock = threading.Lock()
_flusher_owner: str | None = None


def claim_flusher(owner: str) -> bool:
    global _flusher_owner
    with _flusher_lock:
        if _flusher_owner is not None and _flusher_owner != owner:
            return False
        _flusher_owner = owner
        _activate()
        return True


def release_flusher(owner: str):
    global _flusher_owner
    with _flusher_lock:
        if _flusher_owner == owner:
            _flusher_owner = None
            _deactivate()
