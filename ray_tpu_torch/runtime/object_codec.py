"""Binary layout for objects in the shared-memory store.

Port of ``ray_tpu/runtime/object_codec.py`` without the memory plane's
store-full attribution ring (the observability planes are a later
slice). Reference analog: plasma's data+metadata split (``plasma.fbs``)
combined with Ray's Pickle5 out-of-band serialization
(``python/ray/_private/serialization.py``). Layout:

    [u8 flags][u64 n_sections][u64 len_0 .. len_{n-1}][section bytes ...]

Section 0 is the pickle meta stream; sections 1..n-1 are out-of-band
buffers, written straight into the shm mapping and copied out once on read
(``decode_view``).

flags bit 0: error object (deserialized value is an exception to raise).
"""

from __future__ import annotations

import struct

from ray_tpu_torch.runtime.refcount import global_counter as _refs
from ray_tpu_torch.runtime.serialization import SerializedObject, deserialize, serialize

_U64 = struct.Struct("<Q")
FLAG_ERROR = 1


def _serialize_capturing(value):
    """Serialize, capturing any ObjectRef pickled inside the value
    (reference: contained-in tracking, reference_count.h:67). Returns
    ``(obj, captured_oid_hexes)`` — the caller records the
    contains-edges only AFTER the store write succeeds; reporting a
    failed put's edges would inflate the inner refcounts forever."""
    with _refs.capture() as cap:
        obj = serialize(value)
    return obj, cap.oids


def _note_contains(object_id: bytes, caught):
    if caught:
        _refs.add_contains(object_id.hex(), caught)


def encoded_size(obj: SerializedObject) -> int:
    n = 1 + len(obj.buffers)
    return 1 + 8 + 8 * n + len(obj.meta) + sum(
        memoryview(b).nbytes for b in obj.buffers)


def encode_into(buf: memoryview, obj: SerializedObject, *, is_error: bool = False):
    """Write the object into a writable view (from ShmObjectStore.create)."""
    sections = [obj.meta] + [memoryview(b).cast("B") for b in obj.buffers]
    buf[0] = FLAG_ERROR if is_error else 0
    off = 1
    buf[off:off + 8] = _U64.pack(len(sections))
    off += 8
    for s in sections:
        buf[off:off + 8] = _U64.pack(memoryview(s).nbytes)
        off += 8
    for s in sections:
        s = memoryview(s).cast("B")
        buf[off:off + s.nbytes] = s
        off += s.nbytes


def decode_view(view: memoryview):
    """(value, is_error) from a read-only store view. The out-of-band
    buffers (arrays, tensors) are copied into private memory: a value
    aliasing its store slot would outlive the read ref that protects the
    slot, which the store then spills and reuses for another object. (The
    JAX package maps them zero-copy, and such an array can change under
    its reader once the store is under pressure.)"""
    flags = view[0]
    off = 1
    (n,) = _U64.unpack(view[off:off + 8])
    off += 8
    lens = []
    for _ in range(n):
        (ln,) = _U64.unpack(view[off:off + 8])
        off += 8
        lens.append(ln)
    sections = []
    for ln in lens:
        sections.append(view[off:off + ln])
        off += ln
    meta = bytes(sections[0])
    value = deserialize(SerializedObject(
        meta=meta, buffers=[bytearray(b) for b in sections[1:]]))
    return value, bool(flags & FLAG_ERROR)


def put_value(store, object_id: bytes, value, *, is_error: bool = False) -> int:
    """Serialize + write + seal into a ShmObjectStore. Returns byte size.

    First-write-wins: if the object already exists (e.g. a restarted actor
    re-running its creation task, or racing error/result writers), the put
    is a no-op returning 0 — consumers observe whichever write sealed first,
    matching the local-mode store's semantics."""
    from ray_tpu_torch._private.shm_store import ObjectExistsError

    obj, caught = _serialize_capturing(value)
    size = encoded_size(obj)
    try:
        buf = store.create(object_id, size)
    except ObjectExistsError:
        return 0
    try:
        encode_into(buf, obj, is_error=is_error)
    finally:
        del buf
    store.seal(object_id)
    _note_contains(object_id, caught)
    return size


def put_value_durable(store, object_id: bytes, value, *,
                      is_error: bool = False, request_space=None,
                      timeout_s: float = 30.0, hold: bool = False,
                      preserialized=None, contained=None) -> int:
    """``put_value`` with memory-pressure backoff: when the store is full,
    ask the node manager to make room (synchronous spill of pinned-idle
    objects — ``request_space`` callable takes the needed byte count) and
    retry until the deadline (reference: plasma ``CreateRequestQueue``
    retrying creates while ``LocalObjectManager`` spills). The value is
    serialized ONCE, outside the retry loop.

    ``hold=True`` seals with a kept read ref (see ``ShmObjectStore.seal``)
    so the object cannot be evicted before the caller reports it to the
    node manager for pinning; the caller must ``store.release`` it after.
    """
    import time as _time

    from ray_tpu_torch._private.shm_store import ObjectExistsError, StoreFullError

    if preserialized is not None:
        # a caller (the direct-return size probe) already serialized —
        # never pickle a large value twice
        obj, caught = preserialized, (contained or [])
    else:
        obj, caught = _serialize_capturing(value)
    size = encoded_size(obj)
    deadline = _time.monotonic() + timeout_s
    delay = 0.02
    while True:
        try:
            buf = store.create(object_id, size)
        except ObjectExistsError:
            return 0  # first write wins (see put_value)
        except StoreFullError:
            if _time.monotonic() >= deadline:
                raise
            if request_space is not None:
                try:
                    request_space(size)
                except Exception:  # noqa: BLE001 - raylet busy; retry anyway
                    pass
            _time.sleep(delay)
            delay = min(delay * 2, 0.5)
            continue
        try:
            encode_into(buf, obj, is_error=is_error)
        finally:
            del buf
        store.seal(object_id, hold=hold)
        _note_contains(object_id, caught)
        return size


def get_value(store, object_id: bytes, timeout_ms: int = -1):
    """Read + deserialize. Returns (value, is_error).

    The value owns its memory (``decode_view``), so the read ref is
    dropped once it is decoded."""
    view = store.get(object_id, timeout_ms=timeout_ms)
    try:
        return decode_view(view)
    finally:
        del view
        store.release(object_id)


def raw_bytes(store, object_id: bytes, timeout_ms: int = -1) -> bytes:
    """Copy the full encoded object (for node-to-node transfer)."""
    view = store.get(object_id, timeout_ms=timeout_ms)
    try:
        return bytes(view)
    finally:
        del view
        store.release(object_id)


def encode_bytes(value, *, is_error: bool = False, limit: int | None = None):
    """Serialize a value into the store's binary layout WITHOUT touching
    a store (the direct small-return path: the bytes ride the task
    reply to the owner, who ``put_raw``s them into its local store —
    reference analog: small returns go to the owner's in-process
    memory store in the task reply, ``memory_store.h:43``).

    Returns ``(payload | None, serialized_obj, contained_oids)`` —
    payload is None when the encoded size exceeds ``limit`` (the size
    check runs BEFORE any byte copy, and the serialized form is handed
    back so the store path never re-pickles a large value)."""
    obj, caught = _serialize_capturing(value)
    size = encoded_size(obj)
    if limit is not None and size > limit:
        return None, obj, list(caught)
    buf = bytearray(size)
    encode_into(memoryview(buf), obj, is_error=is_error)
    return bytes(buf), obj, list(caught)


def put_raw(store, object_id: bytes, payload: bytes, *,
            hold: bool = False):
    """Write pre-encoded bytes (receiving side of a transfer).
    ``hold=True`` keeps a read ref through the seal (caller releases)."""
    buf = store.create(object_id, len(payload))
    try:
        buf[:] = payload
    finally:
        del buf
    store.seal(object_id, hold=hold)
