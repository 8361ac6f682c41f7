"""ctypes bindings for the C++ shared-memory object store.

Port of ``ray_tpu/_private/shm_store.py``. The store is the port's own
copy of the C++ source, ``csrc/host/shm_store.cc``, built at first use
with the host compiler (``$CXX``, else ``g++``) into ``_build/`` beside
the package (``_private/build.py``). Reference analog: the plasma client
(``src/ray/object_manager/plasma/client.cc``): create/seal/get/release/
delete with zero-copy reads. There is no store daemon: all processes
attach the same shm segment and the C++ library coordinates through a
robust process-shared mutex inside it.

Zero-copy: ``get`` returns a read-only ``memoryview`` directly over the
mapped segment; ``create`` returns a writable one. Buffers must be released
(``release``) when consumers are done so eviction can reclaim space.
"""

from __future__ import annotations

import ctypes
import threading

from ray_tpu_torch._private import build as _build

TS_OK = 0
TS_ERR = -1
TS_EXISTS = -2
TS_NOT_FOUND = -3
TS_OOM = -4
TS_TABLE_FULL = -5
TS_NOT_SEALED = -6
TS_TIMEOUT = -7

ID_LEN = 20


def _key(object_id: bytes) -> bytes:
    """Store keys are exactly 20 bytes; shorter ids are zero-padded."""
    if len(object_id) > ID_LEN:
        raise ValueError(f"object id longer than {ID_LEN} bytes")
    return object_id.ljust(ID_LEN, b"\x00")


def _load():
    lib = ctypes.CDLL(str(_build.build("shm_store")))
    u64 = ctypes.c_uint64
    p = ctypes.c_void_p
    lib.store_create.restype = p
    lib.store_create.argtypes = [ctypes.c_char_p, u64, u64]
    lib.store_attach.restype = p
    lib.store_attach.argtypes = [ctypes.c_char_p]
    lib.store_close.argtypes = [p]
    lib.store_base.restype = ctypes.c_void_p
    lib.store_base.argtypes = [p]
    lib.store_capacity.restype = u64
    lib.store_capacity.argtypes = [p]
    lib.store_create_object.restype = ctypes.c_int
    lib.store_create_object.argtypes = [p, ctypes.c_char_p, u64, u64,
                                        ctypes.POINTER(u64)]
    lib.store_seal.restype = ctypes.c_int
    lib.store_seal.argtypes = [p, ctypes.c_char_p]
    lib.store_seal_hold.restype = ctypes.c_int
    lib.store_seal_hold.argtypes = [p, ctypes.c_char_p]
    lib.store_get.restype = ctypes.c_int
    lib.store_get.argtypes = [p, ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(u64), ctypes.POINTER(u64),
                              ctypes.POINTER(u64)]
    lib.store_release.restype = ctypes.c_int
    lib.store_release.argtypes = [p, ctypes.c_char_p]
    lib.store_delete.restype = ctypes.c_int
    lib.store_delete.argtypes = [p, ctypes.c_char_p]
    lib.store_abort.restype = ctypes.c_int
    lib.store_abort.argtypes = [p, ctypes.c_char_p]
    lib.store_contains.restype = ctypes.c_int
    lib.store_contains.argtypes = [p, ctypes.c_char_p]
    lib.store_get_many.restype = ctypes.c_int
    lib.store_get_many.argtypes = [p, ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(u64), ctypes.POINTER(u64),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.store_release_many.restype = ctypes.c_int
    lib.store_release_many.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
    lib.store_evict_orphans.restype = ctypes.c_int
    lib.store_evict_orphans.argtypes = [p, u64]
    lib.store_release_pid.restype = ctypes.c_int
    lib.store_release_pid.argtypes = [p, u64]
    lib.store_spill_candidates.restype = ctypes.c_int
    lib.store_spill_candidates.argtypes = [p, u64, ctypes.c_char_p, u64, u64]
    lib.store_stats.argtypes = [p, ctypes.POINTER(u64 * 6)]
    return lib


_lib = None
_lib_lock = threading.Lock()


def get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


class ShmStoreError(Exception):
    pass


class ObjectExistsError(ShmStoreError):
    pass


class ObjectNotFoundError(ShmStoreError):
    pass


class StoreFullError(ShmStoreError):
    pass


def _check(rc: int, what: str):
    if rc == TS_OK:
        return
    if rc == TS_EXISTS:
        raise ObjectExistsError(what)
    if rc in (TS_NOT_FOUND, TS_TIMEOUT):
        raise ObjectNotFoundError(what)
    if rc in (TS_OOM, TS_TABLE_FULL):
        raise StoreFullError(what)
    raise ShmStoreError(f"{what}: rc={rc}")


class _SegmentHandle:
    """Owns the C store handle's lifetime. The store object AND the cached
    whole-segment ctypes array both reference this handle (and nothing
    refers back), so plain refcounting — no cyclic GC — munmaps exactly
    when the last of {store object, escaped view} drops."""

    __slots__ = ("_lib", "_h", "_closed", "cleanup_lock")

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h
        self._closed = False
        # Serializes munmap against the raylet's worker-death cleanup
        # calls (release_pid/evict_orphans): those run on RPC threads
        # and may still be inside the C store when teardown closes it —
        # without this, close() unmaps the segment under a thread
        # blocked on the in-segment mutex (observed SIGSEGV under
        # actor kill-flood churn). Hot-path ops stay lock-free: views
        # escaping past close are already the caller's contract.
        self.cleanup_lock = threading.Lock()

    def close(self):
        with self.cleanup_lock:
            if not self._closed:
                self._closed = True
                self._lib.store_close(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShmObjectStore:
    """One node's shared-memory object store (owner or attached client)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False,
                 table_cap: int = 0):
        lib = get_lib()
        self._lib = lib
        self.name = name
        try:
            from ray_tpu_torch.utils.config import get_config

            self.BATCH_WINDOW = get_config().store_batch_window
        except Exception:  # noqa: BLE001 - standalone use: class default
            pass
        if create:
            if capacity < (1 << 12):
                raise ValueError(
                    f"store capacity must be >= 4 KiB, got {capacity}")
            if table_cap == 0:
                # scale the object table with capacity: the C default
                # (64k entries) chokes small-object floods — a 256 MiB
                # store full of task returns needs hundreds of
                # thousands of entries (~96 B each; the table costs
                # <10% of the arena at this ratio)
                table_cap = min(max(1 << 16, capacity // 1024), 1 << 22)
            self._h = lib.store_create(name.encode(), capacity, table_cap)
        else:
            self._h = lib.store_attach(name.encode())
        if not self._h:
            raise ShmStoreError(
                f"failed to {'create' if create else 'attach'} store {name!r}"
            )
        self._base = lib.store_base(self._h)
        self.capacity = lib.store_capacity(self._h)
        self._closed = False
        # one whole-segment view, sliced per object: slicing a memoryview
        # is ~5x cheaper than a fresh from_address + cast per get. The
        # slice chain (slice -> segment array -> _anchor handle) keeps the
        # MAPPING alive while views escape, without a cycle through this
        # store object — see _SegmentHandle.
        self._handle = _SegmentHandle(lib, self._h)
        seg = (ctypes.c_ubyte * self.capacity).from_address(self._base)
        seg._anchor = self._handle
        self._seg_rw = memoryview(seg).cast("B")
        self._seg_ro = self._seg_rw.toreadonly()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Force-unmap (caller's contract: no views may be in use after).
        Without an explicit close, the mapping is reclaimed by refcount
        when the last of {this object, escaped views} drops — there is
        deliberately no auto-close in __del__, which would munmap under
        a still-escaped view the moment the store object is dropped."""
        if not self._closed:
            self._closed = True
            self._handle.close()

    # -- object ops --------------------------------------------------------
    def _view(self, offset: int, size: int, readonly: bool) -> memoryview:
        seg = self._seg_ro if readonly else self._seg_rw
        return seg[offset:offset + size]

    def create(self, object_id: bytes, data_size: int,
               meta_size: int = 0) -> memoryview:
        """Allocate; returns a writable view of data+meta. Call seal() next."""
        off = ctypes.c_uint64()
        rc = self._lib.store_create_object(
            self._h, _key(object_id), data_size, meta_size, ctypes.byref(off))
        _check(rc, f"create {object_id.hex()}")
        return self._view(off.value, data_size + meta_size, readonly=False)

    def put(self, object_id: bytes, data: bytes | memoryview) -> None:
        """create + copy + seal convenience."""
        data = memoryview(data)
        buf = self.create(object_id, data.nbytes)
        buf[:] = data
        self.seal(object_id)

    def seal(self, object_id: bytes, hold: bool = False) -> None:
        """Seal a created object. ``hold=True`` converts the writer's ref
        into a tracked read ref instead of dropping it — the object is
        never evictable between seal and the node manager's pin; the
        caller must ``release`` after reporting it."""
        fn = self._lib.store_seal_hold if hold else self._lib.store_seal
        _check(fn(self._h, _key(object_id)), f"seal {object_id.hex()}")

    def get(self, object_id: bytes, timeout_ms: int = -1) -> memoryview:
        """Read-only zero-copy view of the data section (bumps refcount)."""
        off = ctypes.c_uint64()
        dsz = ctypes.c_uint64()
        msz = ctypes.c_uint64()
        rc = self._lib.store_get(self._h, _key(object_id), timeout_ms,
                                 ctypes.byref(off), ctypes.byref(dsz),
                                 ctypes.byref(msz))
        _check(rc, f"get {object_id.hex()}")
        return self._view(off.value, dsz.value, readonly=True)

    def release(self, object_id: bytes) -> None:
        self._lib.store_release(self._h, _key(object_id))

    # one C call holds the process-shared store mutex for its whole
    # batch: chunking here bounds the lock-hold time as a property of
    # the API, not of any one caller (the driver's 4096 get window was
    # previously the only thing keeping a huge batch from stalling
    # every other store client on the node). Flag store_batch_window
    # (instance attr set at construction; class attr documents default).
    BATCH_WINDOW = 4096

    def get_many(self, object_ids: list[bytes]) -> list:
        """Batched non-blocking get, chunked to ``BATCH_WINDOW`` ids per
        C call. Returns a view per id, or None where the object is
        absent/unsealed; every non-None entry holds a read ref — pair
        with release_many over the SAME hit set."""
        seg = self._seg_ro
        out: list = []
        for i in range(0, len(object_ids), self.BATCH_WINDOW):
            part = object_ids[i:i + self.BATCH_WINDOW]
            n = len(part)
            keys = b"".join(map(_key, part))
            offs = (ctypes.c_uint64 * n)()
            dszs = (ctypes.c_uint64 * n)()
            rcs = (ctypes.c_int * n)()
            self._lib.store_get_many(self._h, keys, n, offs, dszs, rcs)
            out.extend(
                seg[offs[k]:offs[k] + dszs[k]] if rcs[k] == TS_OK
                else None for k in range(n))
        return out

    def release_many(self, object_ids: list[bytes]) -> None:
        for i in range(0, len(object_ids), self.BATCH_WINDOW):
            part = object_ids[i:i + self.BATCH_WINDOW]
            keys = b"".join(map(_key, part))
            self._lib.store_release_many(self._h, keys, len(part))

    def delete(self, object_id: bytes) -> bool:
        return self._lib.store_delete(self._h, _key(object_id)) == TS_OK

    def abort(self, object_id: bytes) -> bool:
        """Free an UNSEALED entry this process created (failed chunked
        write/pull cleanup); refuses sealed entries and other writers'."""
        return self._lib.store_abort(self._h, _key(object_id)) == TS_OK

    def try_delete(self, object_id: bytes) -> int:
        """Raw delete status: TS_OK, TS_NOT_FOUND (already gone), or
        TS_ERR (still referenced) — spill needs the distinction."""
        return self._lib.store_delete(self._h, _key(object_id))

    def contains(self, object_id: bytes) -> bool:
        return bool(self._lib.store_contains(self._h, _key(object_id)))

    def evict_orphans(self, pid: int = 0) -> int:
        """Reclaim unsealed entries of a dead writer pid (0 = any writer)."""
        with self._handle.cleanup_lock:
            if self._handle._closed:
                return 0
            return self._lib.store_evict_orphans(self._h, pid)

    def release_pid(self, pid: int) -> int:
        """Drop all read refs held by a dead process (crash cleanup)."""
        with self._handle.cleanup_lock:
            if self._handle._closed:
                return 0
            return self._lib.store_release_pid(self._h, pid)

    def spill_candidates(self, target_bytes: int, max_out: int = 512,
                         pin_pid: int = 0) -> list[bytes]:
        """LRU-ordered sealed object ids totaling ``target_bytes`` of
        payload whose only refs are ``pin_pid``'s pin (0 = unreferenced
        entries) — the node manager's spill-victim query."""
        buf = ctypes.create_string_buffer(max_out * ID_LEN)
        n = self._lib.store_spill_candidates(
            self._h, target_bytes, buf, max_out, pin_pid)
        raw = buf.raw
        return [raw[i * ID_LEN:(i + 1) * ID_LEN] for i in range(max(n, 0))]

    def pin(self, object_id: bytes) -> bool:
        """Hold a read ref WITHOUT mapping a view (the node manager's
        primary-copy pin — reference: raylet pinning via
        ``PinObjectIDs``; pinned objects are never LRU-evicted, only
        spilled). Returns False if the object is not sealed yet."""
        off = ctypes.c_uint64()
        dsz = ctypes.c_uint64()
        msz = ctypes.c_uint64()
        rc = self._lib.store_get(self._h, _key(object_id), -1,
                                 ctypes.byref(off), ctypes.byref(dsz),
                                 ctypes.byref(msz))
        return rc == TS_OK

    def unpin(self, object_id: bytes) -> None:
        self.release(object_id)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 6)()
        self._lib.store_stats(self._h, ctypes.byref(out))
        return {
            "capacity": out[0],
            "bytes_allocated": out[1],
            "num_objects": out[2],
            "num_evictions": out[3],
            "bytes_evicted": out[4],
            "lru_clock": out[5],
        }
