"""Per-node local object manager: primary-copy pins, the GCS location
directory view, spilling to disk, restore, and serving/pulling chunked
transfers.

Reference analog: ``src/ray/raylet/local_object_manager.cc`` (pin +
spill/restore of primaries), ``src/ray/object_manager/`` (chunked
transfer serving + PullManager), and the external-storage file backend
(``_private/external_storage.py``). A component OWNED by the raylet
(``runtime/raylet.py``): the raylet exposes thin ``rpc_*`` delegators
and passes itself in for GCS access and peer resolution.

Port of ``ray_tpu/runtime/object_manager.py`` without the memory plane's
occupancy decomposition, make-room attribution and gauges (the
observability planes are a later slice).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

from ray_tpu_torch._private.shm_store import ObjectNotFoundError
from ray_tpu_torch.runtime import object_codec
from ray_tpu_torch.utils.ids import ObjectID

class SpillStorage:
    """Spill target behind a tiny FS interface: a local directory (fast
    path: plain files, range reads by seek) or ANY pyarrow.fs URI —
    ``s3://bucket/prefix``, ``gs://...``, ``file:///...`` (reference:
    external_storage.py smart_open/S3 spilling). Cloud targets make
    spilled objects survive node loss and unbound by local disk."""

    def __init__(self, target: str):
        self._uri = "://" in target
        if self._uri:
            import pyarrow.fs as pafs

            self.fs, base = pafs.FileSystem.from_uri(target)
            self.base = base.rstrip("/")
        else:
            self.base = target

    def path(self, name: str) -> str:
        return f"{self.base}/{name}" if self._uri \
            else os.path.join(self.base, name)

    def write(self, path: str, payload: bytes):
        if not self._uri:
            os.makedirs(self.base, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
            return
        self.fs.create_dir(self.base, recursive=True)
        try:
            with self.fs.open_output_stream(path) as f:
                f.write(payload)
        except Exception:
            # URI writes go straight to the final name (cloud rename is
            # a copy): a failed stream must not leave a truncated object
            self.unlink(path)
            raise

    def read(self, path: str) -> bytes:
        if not self._uri:
            with open(path, "rb") as f:
                return f.read()
        with self.fs.open_input_stream(path) as f:
            return f.read()

    def read_range(self, path: str, offset: int, length: int) -> bytes:
        if not self._uri:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        with self.fs.open_input_file(path) as f:
            f.seek(offset)
            return f.read(length)

    def exists(self, path: str) -> bool:
        try:
            if not self._uri:
                return os.path.exists(path)
            import pyarrow.fs as pafs

            info = self.fs.get_file_info(path)
            return info.type != pafs.FileType.NotFound
        except Exception:  # noqa: BLE001 - target unreachable: assume
            return True    # the file may still exist — never orphan it

    def unlink(self, path: str):
        try:
            if not self._uri:
                os.unlink(path)
            else:
                self.fs.delete_file(path)
        except Exception:  # noqa: BLE001 - already gone
            pass

    def cleanup(self):
        try:
            if not self._uri:
                shutil.rmtree(self.base, ignore_errors=True)
            else:
                self.fs.delete_dir_contents(self.base,
                                            missing_dir_ok=True)
        except Exception:  # noqa: BLE001 - best-effort
            pass


class LocalObjectManager:
    """Object lifecycle for one raylet node. ``node`` is the owning
    Raylet (identity, GCS client, peer table, stopping flag)."""

    def __init__(self, node, *, store, store_capacity: int, cfg):
        self._node = node
        self.store = store
        # --- object spilling (reference: LocalObjectManager::SpillObjects
        # local_object_manager.h:110 + external_storage.py
        # FileSystemStorage). Spilled objects leave shm for files in
        # _spill_dir; the GCS location entry stays (this node can still
        # serve them), and any local read restores them into shm first.
        self.spill_enabled = cfg.object_spilling_enabled
        self._spill_high = cfg.object_spilling_high_fraction
        self._spill_low = cfg.object_spilling_low_fraction
        # always a per-raylet SUBdirectory: stop() removes the whole dir,
        # and a shared configured path must not nuke other raylets' files.
        # The base may be a pyarrow.fs URI (s3:// gs:// file://) — cloud
        # spill targets (reference: external_storage.py).
        _spill_base = (cfg.object_spilling_directory
                       or tempfile.gettempdir())
        sub = f"raytpu_spill_{os.getpid()}_{node.node_id[:8]}"
        self.spill_is_local = "://" not in _spill_base
        self.spill_dir = (os.path.join(_spill_base, sub)
                          if self.spill_is_local
                          else f"{_spill_base.rstrip('/')}/{sub}")
        self._spill_fs = SpillStorage(self.spill_dir)
        # oid hex -> (file path, was_primary): primaries re-pin on
        # restore; spilled secondaries stay evictable after restore
        self._spilled: dict[str, tuple[str, bool]] = {}
        self._spill_lock = threading.Lock()
        # oids with a spill IN PROGRESS (guarded by _spill_lock): the
        # spill loop and request_space callers race otherwise — the
        # second spiller captures was_primary=False (the first already
        # unpinned) and OVERWRITES the entry, so the restore came back
        # unpinned and the object's only copy became LRU-evictable
        # (lost ~1 in 200k task returns under memory pressure)
        self._spilling: set[str] = set()
        self.spill_stats = {"num_spilled": 0, "bytes_spilled": 0,
                            "num_restored": 0, "bytes_restored": 0,
                            "spill_wall_s": 0.0, "restore_wall_s": 0.0}
        # Primary-copy pins: every object CREATED on this node is pinned
        # (one raylet-held read ref) so the store's LRU eviction can never
        # destroy the sole copy — memory is reclaimed by SPILLING pinned
        # objects instead (reference: raylet PinObjectIDs + spill-only
        # reclamation of primaries; secondary/pulled copies stay
        # unpinned and evictable).
        self._pinned: set[str] = set()
        self._pin_lock = threading.Lock()
        # debug: trace pin/deregister history for scale-run loss hunts
        # (RAY_TPU_DEBUG_OBJECT_TRACE=/path enables; bounded cost)
        self._trace_path = os.environ.get("RAY_TPU_DEBUG_OBJECT_TRACE")
        self._ever_pinned: set[str] | None = (set() if self._trace_path
                                              else None)
        # every object registered with the GCS as located here (primary or
        # pulled secondary); reconciled against the store so LRU-evicted
        # secondaries don't leave stale locations in the directory forever
        # (reference: object-eviction pubsub updating the ObjectDirectory)
        self._local_objects: set[str] = set()
        self._local_objects_lock = threading.Lock()
        # oid -> (size, crc32): transfer-integrity probe memo (objects
        # are immutable; bounded FIFO)
        self._crc_cache: dict[str, tuple] = {}
        # buffered object-location registrations (batched to the GCS)
        self._loc_buf: list[tuple[str, int]] = []
        self._loc_cv = threading.Condition()
        # wakes ensure_local waiters when an object becomes local
        self._local_cv = threading.Condition()
        # chunked pull plane (reference: PullManager pull_manager.h:52)
        from ray_tpu_torch.runtime.pull_manager import PullManager
        self.pulls = PullManager(
            fetch_local=self.restore_spilled,
            peer_addresses=self.peer_addresses_for,
            store=store,
            on_pulled=self._on_pulled,
            chunk_size=cfg.object_transfer_chunk_bytes,
            max_in_flight_bytes=max(
                int(store_capacity
                    * cfg.object_transfer_inflight_fraction),
                cfg.object_transfer_chunk_bytes),
        )

    def stop(self):
        self.pulls.stop()

    def cleanup_disk(self):
        self._spill_fs.cleanup()

    def _trace(self, msg: str):
        if self._trace_path:
            try:
                with open(self._trace_path, "a") as f:
                    f.write(f"{self._node.node_id[:8]} {msg}\n")
            except OSError:
                pass

    # ------------------------------------------------------------------
    # local tracking + pins + the GCS directory view
    # ------------------------------------------------------------------

    def track_local(self, oid_hex: str):
        with self._local_objects_lock:
            self._local_objects.add(oid_hex)
        # wake ensure_local waiters (event-driven instead of polling for
        # the locally-produced-object case)
        with self._local_cv:
            self._local_cv.notify_all()

    def reconcile_locations(self):
        """Deregister objects that silently left the store (LRU-evicted
        secondaries): a stale directory entry would make owners pull from
        a node that cannot serve, and would mask true object loss from
        the lineage-reconstruction path."""
        node = self._node
        with self._local_objects_lock:
            snapshot = list(self._local_objects)
        gone = []
        for oid_hex in snapshot:
            # _spilled FIRST, store second: a concurrent restore pops
            # _spilled only AFTER the shm copy is secured+pinned, so this
            # order can never classify a mid-restore object as gone
            # (store-first could: miss the store, then miss _spilled
            # right after the restore completed)
            with self._spill_lock:
                if oid_hex in self._spilled:
                    continue   # spilled = still servable from disk
            if self.store.contains(bytes.fromhex(oid_hex)):
                continue
            gone.append(oid_hex)
        if not gone:
            return
        if self._ever_pinned is not None:
            for oid_hex in gone:
                if oid_hex in self._ever_pinned:
                    self._trace(f"RECONCILE-DROP-PINNED {oid_hex} "
                                f"pinned_now={self.is_pinned(oid_hex)}")
        with self._local_objects_lock:
            self._local_objects.difference_update(gone)
        with self._pin_lock:
            self._pinned.difference_update(gone)
        for oid_hex in gone:
            try:
                with node._gcs_lock:
                    node._gcs.call("remove_object_location", oid=oid_hex,
                                   node_id=node.node_id)
            except Exception:  # noqa: BLE001 - gcs down; retried next tick
                with self._local_objects_lock:
                    self._local_objects.add(oid_hex)

    def pin_object(self, oid_hex: str):
        """Pin a newly created primary copy (idempotent)."""
        with self._pin_lock:
            if oid_hex in self._pinned:
                return
            if self.store.pin(bytes.fromhex(oid_hex)):
                self._pinned.add(oid_hex)
                if self._ever_pinned is not None:
                    self._ever_pinned.add(oid_hex)
            elif self._ever_pinned is not None:
                self._trace(f"PIN-FAILED {oid_hex}")

    def unpin_object(self, oid_hex: str):
        with self._pin_lock:
            if oid_hex in self._pinned:
                self._pinned.discard(oid_hex)
                self.store.unpin(bytes.fromhex(oid_hex))

    def _capture_and_unpin(self, oid_hex: str) -> bool:
        """Atomically read-and-clear the pin (spill_one's primary-copy
        capture). One locked section: a pin landing between a separate
        capture and unpin would be silently erased — the spilled entry
        would record was_primary=False, its restore would come back
        UNPINNED, and LRU eviction could then destroy the object's only
        copy (seen once per ~200k task returns under spill pressure)."""
        with self._pin_lock:
            was = oid_hex in self._pinned
            if was:
                self._pinned.discard(oid_hex)
                self.store.unpin(bytes.fromhex(oid_hex))
            return was

    def is_pinned(self, oid_hex: str) -> bool:
        with self._pin_lock:
            return oid_hex in self._pinned

    def report_object(self, oid: str, size: int = 0) -> bool:
        """A local process created an object: pin the primary copy and
        register the location with the GCS (reference: the Put path's
        PinObjectIDs + object directory update). Callers seal with a held
        ref (``seal(hold=True)``) so the object cannot vanish before the
        pin lands here.

        The PIN is synchronous (it is what makes the object durable); the
        GCS directory registration is BUFFERED and flushed in batches —
        one directory RPC per flush, not per task return, keeping the
        head-node round trip off the task hot path (reference: the
        ownership-based object directory is similarly not on the task
        completion critical path)."""
        self.pin_object(oid)
        if not self.is_pinned(oid):
            # the object may have been spilled BEFORE this pin landed
            # (memory pressure racing the batched report): the spill
            # entry then says was_primary=False — promote it, or its
            # restore would come back unpinned and evictable as the
            # object's only copy
            with self._spill_lock:
                entry = self._spilled.get(oid)
                if entry is not None and not entry[1]:
                    self._spilled[oid] = (entry[0], True)
            if entry is None and not self.store.contains(
                    bytes.fromhex(oid)):
                # should be unreachable under the hold protocol; never
                # advertise a location that cannot serve the object
                return False
        self.track_local(oid)
        self.queue_location(oid, size)
        return True

    def queue_location(self, oid: str, size: int):
        with self._loc_cv:
            self._loc_buf.append((oid, size))
            self._loc_cv.notify()

    def location_flush_loop(self):
        """Drain the location buffer into batched GCS registrations. A
        short linger coalesces bursts; an empty buffer blocks on the cv
        (no polling)."""
        node = self._node
        while not node._stopping:
            with self._loc_cv:
                if not self._loc_buf:
                    self._loc_cv.wait(timeout=0.2)
                if not self._loc_buf:
                    continue
                time_to_linger = 0.002
            time.sleep(time_to_linger)  # let the burst accumulate
            with self._loc_cv:
                batch, self._loc_buf = self._loc_buf, []
            if not batch:
                continue
            try:
                with node._gcs_lock:
                    node._gcs.call("add_object_locations",
                                   node_id=node.node_id, entries=batch)
            except Exception:  # noqa: BLE001 - GCS down; heartbeat
                pass           # reconciliation re-registers local objects

    # ------------------------------------------------------------------
    # explicit free (reference: ray.internal.free)
    # ------------------------------------------------------------------

    def free_objects(self, oids: list, deregister: bool = True) -> int:
        """Release local copies: unpin, drop from shm and the spill dir,
        deregister locations. Returns the number of copies freed.

        ``deregister=False``: the free was INITIATED by the GCS
        (refcount hit zero — the directory entry is already gone), so
        skip the remove_object_location round trips and the lost-object
        tombstoning they would cause."""
        from ray_tpu_torch._private.shm_store import TS_ERR, TS_OK

        node = self._node
        freed = 0
        pending: list[tuple[str, bool, bool]] = []  # (oid, pinned, spilled)
        for oid_hex in oids:
            if node._stopping:
                return freed   # store is about to unmap: never touch it
            was_pinned = self.is_pinned(oid_hex)
            self.unpin_object(oid_hex)
            with self._spill_lock:
                entry = self._spilled.pop(oid_hex, None)
            if entry is not None:
                self._spill_fs.unlink(entry[0])
                freed += 1
            pending.append((oid_hex, was_pinned, entry is not None))
        # drain in-flight refs (a writer's seal-hold released right after
        # its report RPC, or a reader mid-get) with ONE shared ~200ms
        # budget across all oids, not per object
        done: list[tuple[str, bool, int]] = []
        deadline = time.monotonic() + 0.2
        while pending:
            still = []
            for oid_hex, was_pinned, had_spill in pending:
                if node._stopping:
                    return freed   # mid-batch shutdown: bail before the
                    # munmap (a large refcount release riding a heartbeat
                    # was segfaulting here at teardown)
                rc = self.store.try_delete(bytes.fromhex(oid_hex))
                if rc == TS_ERR and time.monotonic() < deadline:
                    still.append((oid_hex, was_pinned, had_spill))
                else:
                    done.append((oid_hex, had_spill, rc))
                    if rc == TS_ERR and was_pinned:
                        # a reader outlived the drain: the surviving
                        # primary stays authoritative — re-pin it so LRU
                        # eviction cannot silently orphan the stale GCS
                        # location (same rule as spill_one)
                        self.pin_object(oid_hex)
            pending = still
            if pending:
                time.sleep(0.01)
        for oid_hex, had_spill, rc in done:
            if rc == TS_OK and not had_spill:
                freed += 1
            if rc == TS_ERR:
                continue   # copy stays: tracked, registered, re-pinned
            with self._local_objects_lock:
                was_local = oid_hex in self._local_objects
                self._local_objects.discard(oid_hex)
            if deregister and (was_local or had_spill):
                try:
                    with node._gcs_lock:
                        node._gcs.call("remove_object_location",
                                       oid=oid_hex, node_id=node.node_id)
                except Exception:  # noqa: BLE001 - best-effort
                    pass
        return freed

    # ------------------------------------------------------------------
    # spilling (reference: LocalObjectManager + ExternalStorage — spill
    # LRU-cold objects to files under memory pressure, restore on read)
    # ------------------------------------------------------------------

    def request_space(self, nbytes: int = 0) -> int:
        """A writer hit store-OOM: synchronously spill pinned-idle objects
        to make room (reference: CreateRequestQueue retry + triggered
        spill). Returns the number of objects spilled."""
        if not self.spill_enabled:
            return 0  # honor the no-disk-writes contract
        # floor scaled to the allocation (2x for headroom) and the store
        # (1/8 capacity) — a fixed large floor would thrash small stores
        cap = self.store.capacity
        target = min(max(2 * int(nbytes), cap // 8), cap)
        n = self.spill_bytes(target)
        if n == 0:
            # nothing pinned-idle; last resort, spill unpinned cold
            # entries too (they are evictable anyway — spilling keeps
            # them readable instead of destroying them)
            for oid in self.store.spill_candidates(target, pin_pid=0):
                oid_hex = oid[:ObjectID.SIZE].hex()
                if self.spill_one(oid[:ObjectID.SIZE]):
                    n += 1
        return n

    def spill_bytes(self, target: int) -> int:
        n = 0
        for oid in self.store.spill_candidates(target,
                                               pin_pid=os.getpid()):
            if self.spill_one(oid[:ObjectID.SIZE]):
                n += 1
        return n

    def spill_loop(self):
        node = self._node
        while not node._stopping:
            time.sleep(0.2)
            try:
                st = self.store.stats()
            except Exception:  # noqa: BLE001 - store closing
                return
            cap = st["capacity"] or 1
            if st["bytes_allocated"] <= self._spill_high * cap:
                continue
            self.spill_bytes(
                st["bytes_allocated"] - int(self._spill_low * cap))

    def spill_one(self, oid: bytes) -> bool:
        """Copy one sealed object out to a file, then drop it from shm.
        Exclusive per oid: concurrent spillers (the spill loop racing a
        request_space caller) corrupt the was_primary flag."""
        oid_hex = oid.hex()
        with self._spill_lock:
            if oid_hex in self._spilling or oid_hex in self._spilled:
                return False
            self._spilling.add(oid_hex)
        try:
            return self._spill_one_locked(oid, oid_hex)
        finally:
            with self._spill_lock:
                self._spilling.discard(oid_hex)

    def _spill_one_locked(self, oid: bytes, oid_hex: str) -> bool:
        t0 = time.perf_counter()
        try:
            payload = object_codec.raw_bytes(self.store, oid, timeout_ms=0)
        except Exception:  # noqa: BLE001 - vanished (freed/evicted) — fine
            return False
        path = self._spill_fs.path(oid_hex)
        try:
            self._spill_fs.write(path, payload)
        except Exception:  # noqa: BLE001 - target full/unreachable
            self._spill_fs.unlink(path + ".tmp")
            return False
        from ray_tpu_torch._private.shm_store import TS_ERR, TS_OK

        was_primary = self._capture_and_unpin(oid_hex)
        with self._spill_lock:
            self._spilled[oid_hex] = (path, was_primary)
        rc = self.store.try_delete(oid)
        if rc == TS_ERR:
            # a reader still holds a ref: keep the shm copy authoritative —
            # re-pin, discard the file
            self.pin_object(oid_hex)
            with self._spill_lock:
                self._spilled.pop(oid_hex, None)
            self._spill_fs.unlink(path)
            return False
        # TS_OK: we removed it. TS_NOT_FOUND: a concurrent evict/spill beat
        # us to it — the file we just wrote may now be the ONLY copy, so it
        # must stay registered either way.
        self.spill_stats["num_spilled"] += 1
        self.spill_stats["bytes_spilled"] += len(payload)
        self.spill_stats["spill_wall_s"] += time.perf_counter() - t0
        return rc == TS_OK

    def restore_spilled(self, oid_hex: str) -> bool:
        """Load a locally-spilled object back into shm (for readers)."""
        t0 = time.perf_counter()
        with self._spill_lock:
            entry = self._spilled.get(oid_hex)
        if entry is None:
            return False
        path, was_primary = entry
        try:
            payload = self._spill_fs.read(path)
        except Exception:  # noqa: BLE001 - file gone OR target down
            # drop the entry only when the file is CONFIRMED absent — a
            # transient cloud-backend error (throttle, reset) must not
            # orphan the sole copy of a spilled primary
            if not self._spill_fs.exists(path):
                with self._spill_lock:
                    self._spilled.pop(oid_hex, None)
            return False
        from ray_tpu_torch._private.shm_store import (ObjectExistsError,
                                                StoreFullError)

        oid = bytes.fromhex(oid_hex)
        held = False
        for _ in range(8):
            try:
                # hold through the seal: the restored entry must never sit
                # at refcount 0 where eviction/spill could destroy it
                # before we pin + unlink the file
                object_codec.put_raw(self.store, oid, payload, hold=True)
                held = True
                break
            except ObjectExistsError:
                break  # racing restore won; theirs is pinned
            except StoreFullError:
                # make room by spilling OTHER pinned-idle objects
                if self.spill_bytes(len(payload)) == 0:
                    time.sleep(0.05)  # wait for readers to release
            except Exception:  # noqa: BLE001 - racing restore
                break
        if was_primary:
            self.pin_object(oid_hex)   # restored primary: pin again
        if held:
            self.store.release(oid)
        if was_primary:
            ok = self.is_pinned(oid_hex)
        else:
            # secondary: stays unpinned/evictable; success = it is present
            ok = held or self.store.contains(oid)
        if not ok:
            # could not secure the shm copy — the file stays the
            # authoritative copy; do NOT unlink
            return self.store.contains(oid)
        with self._spill_lock:
            self._spilled.pop(oid_hex, None)
        self._spill_fs.unlink(path)
        self.spill_stats["num_restored"] += 1
        self.spill_stats["bytes_restored"] += len(payload)
        self.spill_stats["restore_wall_s"] += time.perf_counter() - t0
        return True

    def read_spilled(self, oid_hex: str) -> bytes | None:
        """Read a spilled object's bytes without restoring it to shm
        (serving a remote fetch should not churn local memory)."""
        with self._spill_lock:
            entry = self._spilled.get(oid_hex)
        if entry is None:
            return None
        try:
            return self._spill_fs.read(entry[0])
        except Exception:  # noqa: BLE001
            return None

    # ------------------------------------------------------------------
    # transfer serving (reference: object_manager.cc chunked transfer)
    # ------------------------------------------------------------------

    def fetch_object(self, oid: str) -> bytes:
        """The encoded object bytes from the local store (or spill file)."""
        try:
            return object_codec.raw_bytes(self.store, bytes.fromhex(oid),
                                          timeout_ms=0)
        except ObjectNotFoundError:
            payload = self.read_spilled(oid)
            if payload is None:
                raise
            return payload

    def fetch_object_meta(self, oid: str) -> dict:
        """Size + CRC probe for the pull path (reference: the object
        directory carries sizes for PullManager admission; the checksum
        is transfer integrity — the destination verifies the assembled
        bytes before SEALING, so a torn read can never become a readable
        object). Objects are immutable, so size+CRC memoize per oid —
        repeat probes (N pullers, retries) cost a dict hit, not an
        O(size) pass on the handler thread."""
        import zlib

        cached = self._crc_cache.get(oid)
        if cached is not None:
            return {"found": True, "size": cached[0], "crc32": cached[1]}
        oid_b = bytes.fromhex(oid)
        try:
            view = self.store.get(oid_b, timeout_ms=0)
            try:
                size, crc = view.nbytes, zlib.crc32(view)
            finally:
                view.release()
                self.store.release(oid_b)
        except ObjectNotFoundError:
            data = self.read_spilled(oid)
            if data is None:
                return {"found": False}
            size, crc = len(data), zlib.crc32(data)
        self._crc_cache[oid] = (size, crc)
        while len(self._crc_cache) > 4096:
            self._crc_cache.pop(next(iter(self._crc_cache)))
        return {"found": True, "size": size, "crc32": crc}

    def fetch_object_chunk(self, oid: str, offset: int, length: int) -> bytes:
        """One chunk of an object's raw encoding (reference:
        ObjectManager chunked transfer, 5 MiB default chunks —
        object_manager.cc:339). Spilled objects are served by file seek —
        no whole-object restore to answer a remote read."""
        oid_b = bytes.fromhex(oid)
        try:
            view = self.store.get(oid_b, timeout_ms=0)
            try:
                return bytes(view[offset:offset + length])
            finally:
                view.release()
                self.store.release(oid_b)
        except ObjectNotFoundError:
            with self._spill_lock:
                entry = self._spilled.get(oid)
            if entry is None:
                raise
            return self._spill_fs.read_range(entry[0], offset, length)

    # ------------------------------------------------------------------
    # pulls (reference: PullManager)
    # ------------------------------------------------------------------

    def ensure_local(self, oids: list, timeout_s: float = 30.0) -> list:
        """Make objects locally readable, pulling from peers as needed.
        Returns the list of oids that could NOT be made local in time.
        Waits are event-driven for locally-produced objects (the common
        case): report_object notifies ``_local_cv``.

        Locations are resolved in BATCHED directory queries per wave:
        per-oid GCS lookups inside the pull path cost one RPC per
        not-yet-produced object per poll — at a 200k-object get that
        melted the control plane."""
        node = self._node
        deadline = time.monotonic() + timeout_s
        missing = [o for o in oids
                   if not self.store.contains(bytes.fromhex(o))]
        while missing and not node._stopping \
                and time.monotonic() < deadline:
            locs: dict = {}
            for i in range(0, len(missing), 5000):
                part = missing[i:i + 5000]
                try:
                    with node._gcs_lock:
                        locs.update(node._gcs.call(
                            "get_object_locations", oids=part))
                except Exception:  # noqa: BLE001 - GCS busy: retry wave
                    break
            still = []
            for oid_hex in missing:
                oid = bytes.fromhex(oid_hex)
                if self.store.contains(oid):
                    continue
                holders = locs.get(oid_hex) or []
                sources = []
                local_hint = False
                for nid in holders:
                    if nid == node.node_id:
                        local_hint = True   # spilled here: restore path
                        continue
                    addr = node._peer_address(nid)
                    if addr is not None:
                        sources.append((nid, addr))
                if not sources and not local_hint:
                    still.append(oid_hex)   # not produced anywhere yet
                    continue
                if not self.pulls.pull(oid_hex, known_sources=sources):
                    still.append(oid_hex)
            missing = still
            if missing:
                # wake instantly when a local task seals one of ours;
                # re-check remote locations on a coarser cadence
                with self._local_cv:
                    self._local_cv.wait(
                        timeout=min(0.2, max(deadline - time.monotonic(),
                                             0.0)))
        return missing

    def peer_addresses_for(self, oid_hex: str) -> list:
        node = self._node
        with node._gcs_lock:
            locs = node._gcs.call("get_object_locations",
                                  oids=[oid_hex])[oid_hex]
        out = []
        for node_id in locs:
            if node_id == node.node_id:
                continue
            addr = node._peer_address(node_id)
            if addr is not None:
                out.append((node_id, addr))
        return out

    def _on_pulled(self, oid_hex: str, size: int):
        self.track_local(oid_hex)
        self.queue_location(oid_hex, size)

    def spilled_state(self, oid_hex: str) -> bool:
        with self._spill_lock:
            return oid_hex in self._spilled
