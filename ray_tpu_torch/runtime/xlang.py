"""Cross-language (non-pickle) wire format: msgpack.

A copy of ``ray_tpu/runtime/xlang.py``.

Reference analog: the C++/Java clients serialize task args and returns
with msgpack (``bazel/ray_deps_setup.bzl:304`` pulls msgpack for exactly
this; cross-language calls use function DESCRIPTORS, not pickled
closures). This module is a dependency-free msgpack subset codec —
enough for the cross-language value domain:

    nil, bool, int64, float64, str, bin, array, map(str->value)

Python objects outside that domain fail loudly (the cross-language
contract is plain data, like the reference's).

Also defines the function-descriptor convention: a C++/external client
submits ``{"function_ref": "pkg.module:qualname"}`` and the executing
Python worker resolves it by import — never by unpickling code.
"""

from __future__ import annotations

import struct


class XlangEncodeError(TypeError):
    pass


def dumps(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(0x100 + obj)
        elif -(1 << 63) <= obj < (1 << 64):
            if obj >= 0:
                out.append(0xCF)
                out += struct.pack(">Q", obj)
            else:
                out.append(0xD3)
                out += struct.pack(">q", obj)
        else:
            raise XlangEncodeError(f"int out of 64-bit range: {obj}")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n <= 0xFF:
            out += bytes((0xC4, n))
        elif n <= 0xFFFF:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n <= 15:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n <= 15:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise XlangEncodeError(
            f"type {type(obj).__name__} is outside the cross-language "
            f"value domain (nil/bool/int/float/str/bin/array/map)")


def loads(data: bytes):
    obj, off = _unpack(memoryview(data), 0)
    return obj


def _unpack(mv: memoryview, off: int):
    b = mv[off]
    off += 1
    if b <= 0x7F:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if 0x80 <= b <= 0x8F:
        return _unpack_map(mv, off, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(mv, off, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(mv[off:off + n], "utf-8"), off + n
    if b == 0xC0:
        return None, off
    if b == 0xC2:
        return False, off
    if b == 0xC3:
        return True, off
    if b == 0xC4:
        n = mv[off]
        return bytes(mv[off + 1:off + 1 + n]), off + 1 + n
    if b == 0xC5:
        (n,) = struct.unpack_from(">H", mv, off)
        return bytes(mv[off + 2:off + 2 + n]), off + 2 + n
    if b == 0xC6:
        (n,) = struct.unpack_from(">I", mv, off)
        return bytes(mv[off + 4:off + 4 + n]), off + 4 + n
    if b == 0xCA:
        (v,) = struct.unpack_from(">f", mv, off)
        return v, off + 4
    if b == 0xCB:
        (v,) = struct.unpack_from(">d", mv, off)
        return v, off + 8
    if b == 0xCC:
        return mv[off], off + 1
    if b == 0xCD:
        (v,) = struct.unpack_from(">H", mv, off)
        return v, off + 2
    if b == 0xCE:
        (v,) = struct.unpack_from(">I", mv, off)
        return v, off + 4
    if b == 0xCF:
        (v,) = struct.unpack_from(">Q", mv, off)
        return v, off + 8
    if b == 0xD0:
        (v,) = struct.unpack_from(">b", mv, off)
        return v, off + 1
    if b == 0xD1:
        (v,) = struct.unpack_from(">h", mv, off)
        return v, off + 2
    if b == 0xD2:
        (v,) = struct.unpack_from(">i", mv, off)
        return v, off + 4
    if b == 0xD3:
        (v,) = struct.unpack_from(">q", mv, off)
        return v, off + 8
    if b == 0xD9:
        n = mv[off]
        return str(mv[off + 1:off + 1 + n], "utf-8"), off + 1 + n
    if b == 0xDA:
        (n,) = struct.unpack_from(">H", mv, off)
        return str(mv[off + 2:off + 2 + n], "utf-8"), off + 2 + n
    if b == 0xDB:
        (n,) = struct.unpack_from(">I", mv, off)
        return str(mv[off + 4:off + 4 + n], "utf-8"), off + 4 + n
    if b == 0xDC:
        (n,) = struct.unpack_from(">H", mv, off)
        return _unpack_array(mv, off + 2, n)
    if b == 0xDD:
        (n,) = struct.unpack_from(">I", mv, off)
        return _unpack_array(mv, off + 4, n)
    if b == 0xDE:
        (n,) = struct.unpack_from(">H", mv, off)
        return _unpack_map(mv, off + 2, n)
    if b == 0xDF:
        (n,) = struct.unpack_from(">I", mv, off)
        return _unpack_map(mv, off + 4, n)
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _unpack_array(mv, off, n):
    out = []
    for _ in range(n):
        item, off = _unpack(mv, off)
        out.append(item)
    return out, off


def _unpack_map(mv, off, n):
    out = {}
    for _ in range(n):
        k, off = _unpack(mv, off)
        v, off = _unpack(mv, off)
        out[k] = v
    return out, off


def resolve_function_ref(ref: str):
    """Import ``pkg.module:qualname`` (reference: cross-language function
    descriptors resolve by name on the executing side)."""
    import importlib

    module_name, sep, qualname = ref.partition(":")
    if not sep:
        raise ValueError(
            f"function_ref must be 'module:qualname', got {ref!r}")
    obj = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    # unwrap @ray_tpu_torch.remote decoration so a shared module works for both
    # Python and external callers
    return getattr(obj, "underlying_function", obj)
