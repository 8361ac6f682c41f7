"""TFRecord IO without TensorFlow.

Port of ``ray_tpu/data/tfrecord.py`` (reference:
``python/ray/data/datasource/tfrecords_datasource.py``, which binds
``tf.train.Example``). The file format and the Example proto wire format
are spoken directly:

- TFRecord framing: ``uint64 length | uint32 masked_crc(length) | data |
  uint32 masked_crc(data)`` with CRC32C and the TF mask constant.
- ``tf.train.Example`` protobuf: ``features(1) -> map<string(1),
  Feature(2)>``; ``Feature`` is a oneof of ``bytes_list(1)``,
  ``float_list(2)``, ``int64_list(3)``.

The CRC32C is the slicing-by-8 table loop in Python. The JAX package
loads its C/SSE4.2 library (``ray_tpu/_private/libtpucrc.so``) when it
is built; the port loads nothing of the JAX package, and has no copy of
that library yet, so it always takes the Python loop (the same values).
"""

from __future__ import annotations

import struct


# ---------------------------------------------------------------------------
# CRC32C (software table; small and dependency-free)
# ---------------------------------------------------------------------------

def _make_tables():
    """Slicing-by-8 tables: 8 bytes per loop iteration instead of 1, for
    a checksum that runs over every record on both read and write."""
    poly = 0x82F63B78
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[n] & 0xFF] ^ (prev[n] >> 8)
                       for n in range(256)])
    return tables


_T = _make_tables()


_U64S = struct.Struct("<Q")


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    n = len(data)
    i = 0
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    end8 = n - (n % 8)
    unpack = _U64S.unpack_from
    while i < end8:
        (word,) = unpack(data, i)
        word ^= crc
        hi = word >> 32
        crc = (t7[word & 0xFF] ^ t6[(word >> 8) & 0xFF]
               ^ t5[(word >> 16) & 0xFF] ^ t4[(word >> 24) & 0xFF]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
        i += 8
    while i < n:
        crc = t0[(crc ^ data[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a proto message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:            # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:          # fixed64
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:          # length-delimited
            ln, pos = _read_varint(buf, pos)
            value = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:          # fixed32
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_feature(buf: bytes):
    """Feature: oneof bytes_list(1)/float_list(2)/int64_list(3); each
    list holds repeated value(1)."""
    for field, _, value in _iter_fields(buf):
        items: list = []
        if field == 1:      # BytesList
            for f2, _, v2 in _iter_fields(value):
                if f2 == 1:
                    items.append(bytes(v2))
        elif field == 2:    # FloatList (packed or repeated fixed32)
            for f2, w2, v2 in _iter_fields(value):
                if f2 != 1:
                    continue
                if w2 == 2:   # packed
                    items.extend(
                        struct.unpack(f"<{len(v2) // 4}f", v2))
                else:
                    items.append(struct.unpack("<f", v2)[0])
        elif field == 3:    # Int64List (packed or repeated varint)
            for f2, w2, v2 in _iter_fields(value):
                if f2 != 1:
                    continue
                if w2 == 2:   # packed
                    pos = 0
                    while pos < len(v2):
                        item, pos = _read_varint(v2, pos)
                        items.append(_to_signed(item))
                else:
                    items.append(_to_signed(v2))
        return items
    return []


def _to_signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_example(buf: bytes) -> dict:
    """tf.train.Example bytes -> {name: value}; single-element lists
    unwrap (reference behavior)."""
    out: dict = {}
    for field, _, value in _iter_fields(buf):
        if field != 1:      # Example.features
            continue
        for f2, _, entry in _iter_fields(value):
            if f2 != 1:     # Features.feature map entry
                continue
            name = None
            items: list = []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = v3.decode("utf-8")
                elif f3 == 2:
                    items = _parse_feature(v3)
            if name is not None:
                out[name] = items[0] if len(items) == 1 else items
    return out


def build_example(row: dict) -> bytes:
    """{name: value} -> tf.train.Example bytes. Values: bytes/str,
    int, float, or lists thereof."""
    entries = bytearray()
    for name, value in row.items():
        items = value if isinstance(value, (list, tuple)) else [value]
        feat = bytearray()
        if all(isinstance(v, (bytes, str)) for v in items):
            inner = bytearray()
            for v in items:
                b = v.encode("utf-8") if isinstance(v, str) else v
                inner.append(0x0A)           # field 1, wire 2
                _write_varint(inner, len(b))
                inner += b
            feat.append(0x0A)                # bytes_list = field 1
            _write_varint(feat, len(inner))
            feat += inner
        elif all(isinstance(v, bool) or isinstance(v, int)
                 for v in items):
            inner = bytearray()
            for v in items:
                inner.append(0x08)           # field 1, varint
                _write_varint(inner, int(v) & ((1 << 64) - 1))
            feat.append(0x1A)                # int64_list = field 3
            _write_varint(feat, len(inner))
            feat += inner
        elif all(isinstance(v, (int, float)) for v in items):
            packed = struct.pack(f"<{len(items)}f",
                                 *[float(v) for v in items])
            inner = bytearray()
            inner.append(0x0A)               # field 1, packed wire 2
            _write_varint(inner, len(packed))
            inner += packed
            feat.append(0x12)                # float_list = field 2
            _write_varint(feat, len(inner))
            feat += inner
        else:
            raise TypeError(
                f"feature {name!r}: unsupported value {value!r}")
        name_b = name.encode("utf-8")
        entry = bytearray()
        entry.append(0x0A)                   # map key = field 1
        _write_varint(entry, len(name_b))
        entry += name_b
        entry.append(0x12)                   # map value = field 2
        _write_varint(entry, len(feat))
        entry += feat
        entries.append(0x0A)                 # Features.feature = field 1
        _write_varint(entries, len(entry))
        entries += entry
    msg = bytearray()
    msg.append(0x0A)                         # Example.features = field 1
    _write_varint(msg, len(entries))
    msg += entries
    return bytes(msg)


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

def iter_records(data: bytes):
    pos = 0
    n = len(data)
    while pos < n:
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(data[pos:pos + 8]) != len_crc:
            raise ValueError("TFRecord length CRC mismatch")
        start = pos + 12
        record = data[start:start + length]
        (data_crc,) = struct.unpack_from("<I", data, start + length)
        if _masked_crc(record) != data_crc:
            raise ValueError("TFRecord data CRC mismatch")
        yield record
        pos = start + length + 4


def frame_record(record: bytes) -> bytes:
    header = struct.pack("<Q", len(record))
    return (header + struct.pack("<I", _masked_crc(header)) + record
            + struct.pack("<I", _masked_crc(record)))
