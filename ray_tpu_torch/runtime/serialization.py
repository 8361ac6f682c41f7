"""Object serialization with out-of-band buffers.

Port of ``ray_tpu/runtime/serialization.py`` on stdlib ``pickle`` protocol
5, where the JAX package uses cloudpickle (reference:
``python/ray/_private/serialization.py``). Values split into a metadata
stream and out-of-band buffers, so large arrays and tensors travel without
a copy into the stream; the cluster backend writes the buffers into shared
memory and the reader copies them out once (``object_codec.decode_view``).

- Functions and classes travel by reference (module and qualified name).
  One of the driver's ``__main__`` reaches another process as
  multiprocessing's spawn start method carries it: the receiver imports
  the driver's main file by path as ``__mp_main__``, so the file's
  ``if __name__ == "__main__":`` block does not run there. What pickle
  cannot carry by reference (a lambda, a class or function defined inside
  a function) raises ``pickle.PicklingError`` or ``AttributeError``.
- A torch tensor goes out of band as the raw bytes of a contiguous copy,
  with its dtype, shape and strides (bfloat16 has no numpy dtype). A CUDA
  tensor is copied to the host and rebuilt on the receiver's card of the
  same index. Dtype, shape and values arrive bit for bit.
"""

from __future__ import annotations

import importlib.util
import io
import os
import pickle
import sys
import types
from dataclasses import dataclass, field

# the main module of a driver, as a receiving process names its copy
MP_MAIN = "__mp_main__"


@dataclass
class SerializedObject:
    """A serialized value: metadata stream + out-of-band buffers."""

    meta: bytes
    buffers: list = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return len(self.meta) + sum(len(b) for b in self.buffers)


def main_module_path(module_name: str) -> str | None:
    """The file of ``module_name`` when it is this process's main module
    (``__main__``, or ``__mp_main__`` in a process that received one),
    else None."""
    if module_name not in ("__main__", MP_MAIN):
        return None
    path = getattr(sys.modules.get(module_name), "__file__", None)
    return os.path.abspath(path) if path else None


def import_main(path: str):
    """The driver's main file at ``path``, imported once as
    ``__mp_main__`` and made this process's ``__main__`` (multiprocessing
    spawn's ``_fixup_main_from_path``). In the driver itself the file is
    already ``__main__``."""
    here = sys.modules.get("__main__")
    if os.path.abspath(getattr(here, "__file__", "") or "") == path:
        return here
    mod = sys.modules.get(MP_MAIN)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(MP_MAIN, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[MP_MAIN] = mod
    sys.modules["__main__"] = mod
    spec.loader.exec_module(mod)
    return mod


def _lookup(obj, qualname: str):
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _from_main(path: str, qualname: str):
    return _lookup(import_main(path), qualname)


def _rebuild_tensor(buf, dtype: str, shape: tuple, strides: tuple,
                    device, requires_grad: bool, parameter: bool):
    import torch

    dt = getattr(torch, dtype)
    data = memoryview(buf).cast("B")
    if data.nbytes:
        # the tensor takes a writable buffer as its own memory (the
        # store's reads hand private copies); a read-only one is copied
        flat = torch.frombuffer(data if not data.readonly
                                else bytearray(data), dtype=torch.uint8)
        t = flat.view(dt).as_strided(shape, strides)
    else:
        t = torch.empty_strided(shape, strides, dtype=dt)
    if device is not None:
        t = t.to(torch.device("cuda", device))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _reduce_tensor(t):
    import torch

    c = t.detach()
    device = c.device.index if c.device.type == "cuda" else None
    if device is not None and c.device.index is None:
        device = torch.cuda.current_device()
    if c.device.type not in ("cpu", "cuda"):
        raise pickle.PicklingError(
            f"a tensor on {c.device} cannot be serialized")
    c = c.cpu().contiguous()
    raw = c.reshape(-1).view(torch.uint8).numpy() if c.numel() else b""
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(c.dtype).removeprefix("torch."),
             tuple(c.shape), tuple(c.stride()), device, t.requires_grad,
             isinstance(t, torch.nn.Parameter)))


class Pickler(pickle.Pickler):
    """The C pickler with the port's two reducers: torch tensors out of
    band, and the driver's ``__main__`` by file path."""

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)):
            path = main_module_path(getattr(obj, "__module__", "") or "")
            if path is not None and "<locals>" not in obj.__qualname__:
                return _from_main, (path, obj.__qualname__)
            return NotImplemented
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return NotImplemented


def dumps(value, buffer_callback=None) -> bytes:
    """``value`` as protocol-5 pickle bytes through ``Pickler``."""
    stream = io.BytesIO()
    Pickler(stream, protocol=5, buffer_callback=buffer_callback).dump(value)
    return stream.getvalue()


loads = pickle.loads


def serialize(value) -> SerializedObject:
    buffers: list = []

    def buffer_callback(buf: pickle.PickleBuffer):
        buffers.append(buf.raw())
        return False  # do not serialize in-band

    return SerializedObject(meta=dumps(value, buffer_callback),
                            buffers=buffers)


def deserialize(obj: SerializedObject):
    return pickle.loads(obj.meta,
                        buffers=[pickle.PickleBuffer(b) for b in obj.buffers])
