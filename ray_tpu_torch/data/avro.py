"""Avro Object Container File IO without an avro library.

Port of ``ray_tpu/data/avro.py`` (reference:
``python/ray/data/datasource/avro_datasource.py``, which binds the
``avro`` package). The container format (Apache Avro 1.11, "Object
Container Files") and the binary encoding are spoken directly:

- File = magic ``Obj\\x01`` | metadata map (``avro.schema`` JSON,
  ``avro.codec``) | 16-byte sync marker, then data blocks of
  ``long count | long byte-size | payload | sync``.
- Binary encoding: zigzag-varint ints/longs, little-endian IEEE
  float/double, length-prefixed bytes/UTF-8 strings, records as field
  concatenation, arrays/maps as counted blocks with a 0 terminator,
  unions as branch-index + value, enums as index, fixed as raw bytes.
- Codecs: ``null`` and ``deflate`` (raw zlib, no header: RFC 1951).

The writer infers a record schema from the first row when none is given
(None -> nullable union, int -> long, float -> double, str/bytes/bool as
themselves).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import numpy as _np

MAGIC = b"Obj\x01"
SYNC_SIZE = 16


# ---------------------------------------------------------------------------
# primitive binary codec
# ---------------------------------------------------------------------------

def _read_long(buf: io.BytesIO) -> int:
    """Zigzag varint (int and long share the encoding)."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, n: int):
    n = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated avro bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes):
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema-driven decode
# ---------------------------------------------------------------------------

def _decode(schema, buf: io.BytesIO, names: dict):
    """Decode one value of ``schema``. ``names`` maps named-type
    fullnames to their definitions (records/enums/fixed referenced by
    name elsewhere in the schema)."""
    if isinstance(schema, list):                       # union
        idx = _read_long(buf)
        if not 0 <= idx < len(schema):
            raise ValueError(f"union branch {idx} out of range")
        return _decode(schema[idx], buf, names)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            _register(schema, names)
            return {f["name"]: _decode(f["type"], buf, names)
                    for f in schema["fields"]}
        if t == "enum":
            _register(schema, names)
            return schema["symbols"][_read_long(buf)]
        if t == "fixed":
            _register(schema, names)
            return buf.read(schema["size"])
        if t == "array":
            out = []
            while True:
                count = _read_long(buf)
                if count == 0:
                    return out
                if count < 0:          # block with byte-size prefix
                    count = -count
                    _read_long(buf)    # skip block size
                for _ in range(count):
                    out.append(_decode(schema["items"], buf, names))
        if t == "map":
            out = {}
            while True:
                count = _read_long(buf)
                if count == 0:
                    return out
                if count < 0:
                    count = -count
                    _read_long(buf)
                for _ in range(count):
                    key = _read_bytes(buf).decode("utf-8")
                    out[key] = _decode(schema["values"], buf, names)
        # logical types / wrapped primitives: {"type": "long", ...}
        return _decode(t, buf, names)
    # named-type reference or primitive
    if schema in names:
        return _decode(names[schema], buf, names)
    if schema == "null":
        return None
    if schema == "boolean":
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro boolean")
        return b == b"\x01"
    if schema in ("int", "long"):
        return _read_long(buf)
    if schema == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if schema == "bytes":
        return _read_bytes(buf)
    if schema == "string":
        return _read_bytes(buf).decode("utf-8")
    raise ValueError(f"unsupported avro type {schema!r}")


def _register(schema: dict, names: dict):
    name = schema.get("name")
    if name:
        ns = schema.get("namespace")
        names[f"{ns}.{name}" if ns else name] = schema
        names.setdefault(name, schema)


# ---------------------------------------------------------------------------
# schema-driven encode
# ---------------------------------------------------------------------------

def _encode(schema, value, out: io.BytesIO, names: dict):
    if isinstance(schema, list):                       # union
        for idx, branch in enumerate(schema):
            if _matches(branch, value, names):
                _write_long(out, idx)
                _encode(branch, value, out, names)
                return
        raise TypeError(f"{value!r} matches no union branch {schema}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            _register(schema, names)
            for f in schema["fields"]:
                _encode(f["type"], value[f["name"]], out, names)
            return
        if t == "enum":
            _write_long(out, schema["symbols"].index(value))
            return
        if t == "fixed":
            if len(value) != schema["size"]:
                raise ValueError(
                    f"fixed {schema.get('name', '?')} wants "
                    f"{schema['size']} bytes, got {len(value)}")
            out.write(value)
            return
        if t == "array":
            if value:
                _write_long(out, len(value))
                for item in value:
                    _encode(schema["items"], item, out, names)
            _write_long(out, 0)
            return
        if t == "map":
            if value:
                _write_long(out, len(value))
                for k, v in value.items():
                    _write_bytes(out, k.encode("utf-8"))
                    _encode(schema["values"], v, out, names)
            _write_long(out, 0)
            return
        _encode(t, value, out, names)
        return
    if schema in names:
        _encode(names[schema], value, out, names)
        return
    if schema == "null":
        return
    if schema == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif schema in ("int", "long"):
        if isinstance(value, _np.integer):
            value = int(value)  # numpy integer scalars are lossless
        if not isinstance(value, int) or isinstance(value, bool):
            # int(2.7) would silently truncate — schema/value drift
            # (e.g. a float in a column inferred as long) must surface
            raise TypeError(
                f"avro {schema} field got {type(value).__name__} "
                f"{value!r}")
        _write_long(out, value)
    elif schema == "float":
        out.write(struct.pack("<f", float(value)))
    elif schema == "double":
        out.write(struct.pack("<d", float(value)))
    elif schema == "bytes":
        _write_bytes(out, bytes(value))
    elif schema == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    else:
        raise ValueError(f"unsupported avro type {schema!r}")


def _matches(schema, value, names) -> bool:
    t = schema["type"] if isinstance(schema, dict) else schema
    if t in names:
        return _matches(names[t], value, names)
    if t == "null":
        return value is None
    if t == "boolean":
        return isinstance(value, (bool, _np.bool_))
    if t in ("int", "long"):
        return (isinstance(value, (int, _np.integer))
                and not isinstance(value, (bool, _np.bool_)))
    if t in ("float", "double"):
        return isinstance(value, (float, _np.floating))
    if t == "bytes" or t == "fixed":
        return isinstance(value, (bytes, bytearray))
    if t == "string":
        return isinstance(value, str)
    if t == "record" or t == "map":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, (list, tuple))
    if t == "enum":
        return isinstance(value, str)
    return False


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def iter_avro(data: bytes):
    """Yield one dict (or value) per record from container-file bytes."""
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError("not an avro object container file (bad magic)")
    meta = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:
            count = -count
            _read_long(buf)
        for _ in range(count):
            key = _read_bytes(buf).decode("utf-8")
            meta[key] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = buf.read(SYNC_SIZE)
    names: dict = {}
    while True:
        probe = buf.read(1)
        if not probe:
            return
        buf.seek(-1, os.SEEK_CUR)
        count = _read_long(buf)
        size = _read_long(buf)
        payload = buf.read(size)
        if len(payload) != size:
            raise EOFError("truncated avro block")
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        block = io.BytesIO(payload)
        for _ in range(count):
            yield _decode(schema, block, names)
        if buf.read(SYNC_SIZE) != sync:
            raise ValueError("avro sync marker mismatch (corrupt block)")


def infer_schema(row: dict, *, name: str = "row") -> dict:
    """Record schema from a sample row (None → a wide nullable union so
    later rows can hold any primitive; int → long, float → double)."""
    def typeof(v):
        if v is None:
            return ["null", "boolean", "long", "double", "bytes",
                    "string"]
        if isinstance(v, (bool, _np.bool_)):
            return "boolean"
        if isinstance(v, (int, _np.integer)):
            return "long"
        if isinstance(v, (float, _np.floating)):
            return "double"
        if isinstance(v, (bytes, bytearray)):
            return "bytes"
        if isinstance(v, str):
            return "string"
        if isinstance(v, (list, tuple)):
            item = typeof(v[0]) if v else "string"
            return {"type": "array", "items": item}
        if isinstance(v, dict):
            val = typeof(next(iter(v.values()))) if v else "string"
            return {"type": "map", "values": val}
        raise TypeError(f"cannot infer avro type for {type(v).__name__}")

    return {"type": "record", "name": name,
            "fields": [{"name": k, "type": typeof(v)}
                       for k, v in row.items()]}


def write_avro(rows, schema: dict | None = None, *,
               codec: str = "null", sync: bytes = b"\x07" * 16,
               block_records: int = 1000) -> bytes:
    """Encode dict rows into container-file bytes."""
    rows = list(rows)
    if schema is None:
        if not rows:
            raise ValueError("cannot infer a schema from zero rows")
        schema = infer_schema(rows[0])
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8")}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode("utf-8"))
        _write_bytes(out, v)
    _write_long(out, 0)
    out.write(sync)
    names: dict = {}
    for start in range(0, len(rows), block_records):
        chunk = rows[start:start + block_records]
        body = io.BytesIO()
        for row in chunk:
            _encode(schema, row, body, names)
        payload = body.getvalue()
        if codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw RFC1951
        _write_long(out, len(chunk))
        _write_bytes(out, payload)
        out.write(sync)
    return out.getvalue()
