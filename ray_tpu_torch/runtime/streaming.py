"""Streaming generator tasks: ``num_returns="streaming"``.

Port of ``ray_tpu/runtime/streaming.py``. Reference analog:
``StreamingObjectRefGenerator`` / ``ObjectRefGenerator``
(``python/ray/_raylet.pyx:252,267``) with ``num_returns="dynamic" |
"streaming"`` validated at ``_private/ray_option_utils.py:251-253``. A
generator task's yields become ObjectRefs that are consumable WHILE the
task is still running.

Design (no cross-process generator protocol): yield ``i`` of task ``t``
is stored at a DETERMINISTICALLY derived object id ``H(t, i)``, so the
consumer can mint the ref for any index without a round trip, and
readiness is the ordinary object-availability machinery (the store's
seal). End of stream is a count object at ``H(t, END)``; it doubles as
the task's declared return id, so every failure path that seals the
return ids (cancellation, a dead actor) lands an exception exactly where
the consumer's end-of-stream check reads it.
"""

from __future__ import annotations

import hashlib
import struct

from ray_tpu_torch.runtime.object_ref import ObjectRef
from ray_tpu_torch.utils.ids import ObjectID

_END_INDEX = -1


def _active_runtime():
    """The ambient runtime (the public API's implicit init)."""
    from ray_tpu_torch.api import _runtime

    return _runtime()


def stream_oid(task_id_bytes: bytes, index: int) -> ObjectID:
    """Derived object id for yield ``index`` of a streaming task
    (``_END_INDEX`` = the end-of-stream count object)."""
    h = hashlib.blake2b(
        task_id_bytes + struct.pack("<q", index),
        digest_size=ObjectID.SIZE, person=b"raystream")
    return ObjectID(h.digest())


def stream_end_ref(task_id_bytes: bytes) -> ObjectRef:
    # _track=False: these refs are minted transiently on every poll;
    # refcounting them would release live stream objects between polls
    return ObjectRef(stream_oid(task_id_bytes, _END_INDEX), _track=False)


def stream_item_ref(task_id_bytes: bytes, index: int) -> ObjectRef:
    return ObjectRef(stream_oid(task_id_bytes, index), _track=False)


class ObjectRefGenerator:
    """Iterator over a streaming task's yields. ``__next__`` returns the
    next yield's ObjectRef as soon as that yield has been stored —
    ref-by-ref, while the task is still running — and raises
    StopIteration once the stream's count object says the task is done.

    Also usable with ``async for`` (``__anext__`` polls without blocking
    the event loop)."""

    def __init__(self, task_id_bytes: bytes):
        self._task_id = task_id_bytes
        self._next = 0
        self._length: int | None = None

    # -- pickling: consumers may be other tasks/actors -----------------
    def __reduce__(self):
        return (_rebuild_generator, (self._task_id, self._next))

    def __iter__(self):
        return self

    def _check_end(self, runtime) -> bool:
        """True once the stream length is known. Raises if the task
        failed (the failure is sealed into the end object)."""
        if self._length is not None:
            return True
        end = stream_end_ref(self._task_id)
        ready, _ = runtime.wait([end], num_returns=1, timeout=0)
        if not ready:
            return False
        self._length = runtime.get([end])[0]  # raises task errors
        return True

    def _poll(self, timeout: float):
        """One readiness probe; returns the next ref or None."""
        rt = _active_runtime()
        ref = stream_item_ref(self._task_id, self._next)
        ready, _ = rt.wait([ref], num_returns=1, timeout=timeout)
        if ready:
            self._next += 1
            return ref
        if self._check_end(rt) and self._next >= self._length:
            raise StopIteration
        return None

    def __next__(self) -> ObjectRef:
        while True:
            ref = self._poll(timeout=0.05)
            if ref is not None:
                return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        while True:
            try:
                ref = self._poll(timeout=0)
            except StopIteration:
                raise StopAsyncIteration from None
            if ref is not None:
                return ref
            await asyncio.sleep(0.005)

    def completed(self) -> bool:
        try:
            return self._check_end(_active_runtime())
        except Exception:  # noqa: BLE001 - failed stream IS completed
            return True

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()}, next={self._next})"


def _rebuild_generator(task_id_bytes: bytes, next_index: int):
    g = ObjectRefGenerator(task_id_bytes)
    g._next = next_index
    return g


def store_stream(result, task_id_bytes: bytes, put_item, put_end):
    """Drive a generator task's iteration on the executing worker:
    ``put_item(oid_bytes, value, is_error)`` for each yield (sealed
    immediately — consumers see it while the task runs), then
    ``put_end(oid_bytes, count)``. A mid-stream exception is sealed as
    the NEXT yield (the consumer raises it on that ``next()``) and the
    stream is closed after it."""
    index = 0
    try:
        for value in result:
            put_item(stream_oid(task_id_bytes, index).binary(), value,
                     False)
            index += 1
    except BaseException as e:  # noqa: BLE001 - sealed for the consumer
        put_item(stream_oid(task_id_bytes, index).binary(), e, True)
        index += 1
    put_end(stream_oid(task_id_bytes, _END_INDEX).binary(), index)
