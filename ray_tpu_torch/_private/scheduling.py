"""ctypes binding for the C++ scheduling policy (``csrc/host/``).

Port of ``ray_tpu/_private/scheduling.py``. The GCS's resource-driven
node picks call the native hybrid policy (reference:
``hybrid_scheduling_policy.cc:99-186`` + FixedPoint resource math), the
port's own copy of the source built at first use (``_private/build.py``),
so node choices equal the JAX package's. There is no Python fallback:
a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ray_tpu_torch._private import build as _build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build("scheduling")))
        lib.sched_pick_node.restype = ctypes.c_int
        lib.sched_pick_node.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_uint,
        ]
        lib.sched_score_nodes.restype = None
        lib.sched_score_nodes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
        return lib


def _buf(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pick_node(node_ids: list, totals: list[dict], avails: list[dict],
              alive: list[bool], excluded: set, demand: dict, *,
              spread_threshold: float = 0.5, top_k: int = 1,
              seed: int = 0):
    """Returns the chosen node id or None. Resource kinds are the union
    of demand keys (kinds a node lacks count as total=0 → infeasible)."""
    lib = _load()
    # zero-valued demand keys still participate (they contribute node
    # utilization, matching the Python policy); EMPTY demand means every
    # alive node ties at score 0 -> first node, like the Python loop
    kinds = sorted(demand)
    n, k = len(node_ids), len(kinds)
    t = np.zeros((n, k), np.float64)
    a = np.zeros((n, k), np.float64)
    for i in range(n):
        for j, kind in enumerate(kinds):
            t[i, j] = float(totals[i].get(kind, 0.0))
            a[i, j] = float(avails[i].get(kind, 0.0))
    d = np.asarray([float(demand.get(kind, 0.0)) for kind in kinds],
                   np.float64)
    alive_arr = np.asarray([1 if x else 0 for x in alive], np.uint8)
    excl_arr = np.asarray(
        [1 if node_ids[i] in excluded else 0 for i in range(n)], np.uint8)
    idx = lib.sched_pick_node(
        _buf(t), _buf(a), _buf(alive_arr), _buf(excl_arr), n, _buf(d), k,
        float(spread_threshold), int(top_k), int(seed) & 0xFFFFFFFF)
    return node_ids[idx] if idx >= 0 else None


def score_nodes(totals: list[dict], avails: list[dict], alive: list[bool],
                demand: dict) -> list[float]:
    lib = _load()
    kinds = sorted(demand)
    n, k = len(totals), len(kinds)
    t = np.zeros((n, k), np.float64)
    a = np.zeros((n, k), np.float64)
    for i in range(n):
        for j, kind in enumerate(kinds):
            t[i, j] = float(totals[i].get(kind, 0.0))
            a[i, j] = float(avails[i].get(kind, 0.0))
    d = np.asarray([float(demand.get(kind, 0.0)) for kind in kinds],
                   np.float64)
    alive_arr = np.asarray([1 if x else 0 for x in alive], np.uint8)
    out = np.zeros((n,), np.float64)
    lib.sched_score_nodes(_buf(t), _buf(a), _buf(alive_arr), n, _buf(d), k,
                          _buf(out))
    return out.tolist()
