"""Unique identifiers for objects, tasks, actors, nodes, jobs, placement groups.

A copy of ``ray_tpu/utils/ids.py``. Analog of the reference's C++ ID
layer (``src/ray/common/id.h``): fixed-width random IDs with cheap
hashing/equality, hex round-trip, and a ``nil`` sentinel. They are
immutable Python values (bytes-backed), so they pickle compactly and can
cross process boundaries without translation.
"""

from __future__ import annotations

import os
import threading

_HEX = "0123456789abcdef"


class BaseID:
    """Fixed-width immutable identifier backed by raw bytes."""

    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    # Entropy pool: one urandom syscall buys ~256 IDs. from_random is on
    # the per-task submit hot path (2+ IDs per call at 10k+ calls/s), and
    # a 3-4us syscall per ID is real money there. Fork safety: the pool
    # is keyed by pid so children never replay the parent's bytes.
    _pool = b""
    _pool_off = 0
    _pool_pid = 0
    _pool_lock = threading.Lock()

    @classmethod
    def from_random(cls):
        with BaseID._pool_lock:
            off = BaseID._pool_off
            pid = os.getpid()
            if off + cls.SIZE > len(BaseID._pool) or BaseID._pool_pid != pid:
                BaseID._pool = os.urandom(4096)
                BaseID._pool_pid = pid
                off = 0
            BaseID._pool_off = off + cls.SIZE
            return cls(BaseID._pool[off:off + cls.SIZE])

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    SIZE = 16


class TaskID(BaseID):
    SIZE = 12


class ActorID(BaseID):
    SIZE = 12


class NodeID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 12


class _Counter:
    """Thread-safe monotonically increasing counter (sequence numbers)."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value
