"""ObjectRef: a future-like handle to a (possibly not yet computed) object.

Port of ``ray_tpu/runtime/object_ref.py`` (reference: ``ObjectRef``, owned
by the submitting worker; ``src/ray/core_worker/reference_count.h``).
Resolution goes through the active runtime, so refs can be passed freely
as task arguments: the runtime resolves them before execution.
"""

from __future__ import annotations

from ray_tpu_torch.runtime import refcount as _refcount
from ray_tpu_torch.runtime.refcount import global_counter as _refs
from ray_tpu_torch.utils.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner_hint", "_hex", "_tracked", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: str | None = None,
                 _track: bool = True):
        self._id = object_id
        self._owner_hint = owner_hint
        # every live instance contributes to this process's count; the hex
        # is cached so __del__ never touches the (possibly torn-down)
        # ObjectID during interpreter shutdown. ``_track=False`` opts
        # derived refs out (streaming item/end refs are minted and dropped
        # transiently during polling; counting them would free live
        # stream objects).
        self._hex = object_id.hex()
        self._tracked = _track and _refcount.is_active()
        if self._tracked:
            _refs.on_created(self._hex)

    def __del__(self):
        if self._tracked:
            _refs.on_destroyed(self._hex)

    @property
    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._hex

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        if not self._tracked:
            return (_untracked_ref, (self._id, self._owner_hint))
        # a ref pickled inside a put value or a task arg escapes this
        # process: the active capture scope (refcount.RefCounter.capture)
        # records it for contains-edge and task-pin reporting
        _refs.note_serialized(self._hex)
        return (ObjectRef, (self._id, self._owner_hint))

    # Convenience: ref.get() / await-ability via the runtime.
    def get(self, timeout: float | None = None):
        from ray_tpu_torch.runtime.core import get_runtime

        return get_runtime().get([self], timeout=timeout)[0]

    def future(self):
        """Return a concurrent.futures.Future resolved with the object value."""
        from ray_tpu_torch.runtime.core import get_runtime

        return get_runtime().as_future(self)

    def __await__(self):
        import asyncio

        from ray_tpu_torch.runtime.core import get_runtime

        return asyncio.wrap_future(get_runtime().as_future(self)).__await__()


def _untracked_ref(object_id: ObjectID, owner_hint: str | None = None):
    return ObjectRef(object_id, owner_hint, _track=False)
