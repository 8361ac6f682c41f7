"""ctypes binding for the C++ TCP collective backend (``csrc/host/``).

Port of ``ray_tpu/_private/tcp_collective.py``: the host-side CPU data
plane, the Gloo analog of the reference's
``python/ray/util/collective/collective_group/gloo_collective_group.py``.
Ring allreduce, allgather and reduce-scatter, binomial broadcast and
framed tagged p2p, all over direct rank-to-rank TCP sockets (no actor
hop). The library is the port's own copy of the source, built at first
use by ``_private/build.py`` (never at import time); a failed build
raises with the compiler's output.

Usage contract (as NCCL's): every rank issues the same collectives in
the same order. Arrays are numpy arrays or torch tensors (a CUDA tensor
is copied to the host first); dtypes other than float32, float64, int32
and int64 (bf16, f16, bool, ...) are promoted to float32. Results are
numpy arrays, as JAX's.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from ray_tpu_torch._private import build as _build

_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
}
_OPS = {"sum": 0, "prod": 1, "max": 2, "min": 3}

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build("tcp_collective")))
        lib.tc_init.restype = ctypes.c_int
        lib.tc_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_int]
        lib.tc_listen.restype = ctypes.c_int
        lib.tc_listen.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tc_listen_port.restype = ctypes.c_int
        lib.tc_listen_port.argtypes = [ctypes.c_int]
        lib.tc_connect.restype = ctypes.c_int
        lib.tc_connect.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.tc_recv_timeout.restype = ctypes.c_int
        lib.tc_recv_timeout.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        for name, extra in [
            ("tc_allreduce", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int]),
            ("tc_allgather", [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int]),
            ("tc_reduce_scatter", [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int]),
            ("tc_broadcast", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int]),
            ("tc_barrier", []),
            ("tc_send", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int]),
            ("tc_recv", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int]),
            ("tc_destroy", []),
        ]:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] + extra
        _lib = lib
        return lib


def host_array(array) -> np.ndarray:
    """``array`` as a numpy array on the host: a torch tensor (CUDA or
    not) is copied to the host, a bf16 tensor promoted to float32 first
    (numpy has no bf16); anything else goes through ``np.asarray``."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(array, torch.Tensor):
        t = array.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(array)


def _check(rc: int, what: str):
    if rc < 0:
        raise OSError(-rc, f"collective {what} failed: {os.strerror(-rc)}")
    return rc


def _buf(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class TcpGroup:
    """A connected full-mesh collective group.

    One-shot: ``TcpGroup(rank, world, peers)`` with a pre-agreed
    rank->"host:port" listener list (identical on every rank).

    Two-phase (race-free: the listener is bound BEFORE its address is
    advertised): ``g = TcpGroup.listen(rank, world)``, exchange
    ``f"{host}:{g.port}"`` out of band, then ``g.connect(peers)``.
    """

    def __init__(self, rank: int, world_size: int,
                 peers: list[str] | None = None,
                 timeout_ms: int = 30_000, _handle: int | None = None):
        lib = _load()
        if _handle is not None:
            self._h = _handle
        else:
            csv = ",".join(peers).encode()
            self._h = _check(
                lib.tc_init(rank, world_size, csv, timeout_ms), "init")
        self.rank = rank
        self.world_size = world_size
        self._lib = lib

    @classmethod
    def listen(cls, rank: int, world_size: int) -> "TcpGroup":
        lib = _load()
        h = _check(lib.tc_listen(rank, world_size), "listen")
        g = cls(rank, world_size, _handle=h)
        g.port = _check(lib.tc_listen_port(h), "listen_port")
        return g

    def connect(self, peers: list[str], timeout_ms: int = 30_000):
        csv = ",".join(peers).encode()
        _check(self._lib.tc_connect(self._h, csv, timeout_ms), "connect")
        return self

    def _prep(self, array) -> np.ndarray:
        arr = np.ascontiguousarray(host_array(array))
        if arr.dtype not in _DTYPES:
            # promote anything else (bf16, f16, bool, ...) to f32
            arr = arr.astype(np.float32)
        return arr

    def allreduce(self, array, op: str = "sum") -> np.ndarray:
        arr = self._prep(array).copy()
        _check(self._lib.tc_allreduce(
            self._h, _buf(arr), arr.size, _DTYPES[arr.dtype], _OPS[op]),
            "allreduce")
        return arr

    def allgather(self, array) -> list[np.ndarray]:
        arr = self._prep(array)
        out = np.empty((self.world_size,) + arr.shape, dtype=arr.dtype)
        _check(self._lib.tc_allgather(
            self._h, _buf(arr), _buf(out), arr.size, _DTYPES[arr.dtype]),
            "allgather")
        return list(out)

    def reducescatter(self, array, op: str = "sum") -> np.ndarray:
        """``array`` is this rank's full contribution; returns the reduced
        chunk this rank owns, split along axis 0 with ``np.array_split``
        semantics: the actor backend's contract, so the two backends are
        interchangeable."""
        arr = self._prep(array)
        if arr.ndim == 1 and arr.size % self.world_size == 0:
            # the true ring reduce-scatter on equal flat chunks
            per = arr.size // self.world_size
            out = np.empty(per, dtype=arr.dtype)
            _check(self._lib.tc_reduce_scatter(
                self._h, _buf(arr), _buf(out), per, _DTYPES[arr.dtype],
                _OPS[op]), "reducescatter")
            return out
        # an uneven split or ndim > 1: allreduce, then slice here (twice
        # the ring's bytes, but exact array_split semantics)
        red = self.allreduce(arr, op)
        return np.array_split(red, self.world_size)[self.rank]

    def broadcast(self, array, src_rank: int = 0) -> np.ndarray:
        arr = self._prep(array).copy()
        _check(self._lib.tc_broadcast(
            self._h, _buf(arr), arr.size, _DTYPES[arr.dtype], src_rank),
            "broadcast")
        return arr

    def barrier(self):
        _check(self._lib.tc_barrier(self._h), "barrier")

    def send(self, array, dst_rank: int, tag: int = 0):
        arr = self._prep(array)
        header = np.frombuffer(
            _pack_meta(arr.shape, arr.dtype), dtype=np.uint8)
        _check(self._lib.tc_send(
            self._h, _buf(header), header.size, dst_rank, 2 * tag + 1),
            "send-meta")
        _check(self._lib.tc_send(
            self._h, _buf(arr), arr.nbytes, dst_rank, 2 * tag + 2), "send")

    def recv(self, src_rank: int, tag: int = 0,
             timeout: float | None = None) -> np.ndarray:
        tmo = 0 if timeout is None else max(1, int(timeout * 1000))
        header = np.empty(_META_BYTES, dtype=np.uint8)
        rc = self._lib.tc_recv_timeout(
            self._h, _buf(header), header.size, src_rank, 2 * tag + 1, tmo)
        if rc == -110:  # ETIMEDOUT
            raise TimeoutError(
                f"recv from rank {src_rank} (tag {tag}) timed out")
        _check(rc, "recv-meta")
        shape, dtype = _unpack_meta(header.tobytes())
        out = np.empty(shape, dtype=dtype)
        _check(self._lib.tc_recv_timeout(
            self._h, _buf(out), out.nbytes, src_rank, 2 * tag + 2, tmo),
            "recv")
        return out

    def destroy(self):
        if self._h is not None:
            self._lib.tc_destroy(self._h)
            self._h = None


_META_BYTES = 128


def _pack_meta(shape, dtype) -> bytes:
    s = (str(np.dtype(dtype).name) + "|" +
         ",".join(str(d) for d in shape)).encode()
    if len(s) > _META_BYTES - 1:
        raise ValueError("array rank too large for p2p metadata frame")
    return s + b"\0" * (_META_BYTES - len(s))


def _unpack_meta(raw: bytes):
    s = raw.split(b"\0", 1)[0].decode()
    name, _, dims = s.partition("|")
    shape = tuple(int(d) for d in dims.split(",")) if dims else ()
    return shape, np.dtype(name)
