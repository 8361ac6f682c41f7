"""multiprocessing.Pool API over ray_tpu_torch tasks.

Reference analog: ``python/ray/util/multiprocessing/``: a drop-in
``Pool`` so existing ``multiprocessing`` code scales across the cluster
without rewrites. The port carries task bodies by stdlib pickle, so a
pool task is the module-level ``_run`` with a ``_PoolCall`` (a
module-level callable class) as its first argument: both reach a
cluster's workers, and the user's function goes by reference. On the
in-process runtime lambdas and closures work too.
"""

from __future__ import annotations

import itertools
import uuid
from typing import Callable, Iterable

import ray_tpu_torch

# pools whose initializer already ran IN THIS PROCESS (workers import this
# module, so the set is per worker process: the stdlib's once-per-worker
# initializer semantics instead of once-per-task)
_initialized_pools: set[str] = set()


class _PoolCall:
    """One pool task's body: the pool's initializer (once per process),
    then ``fn`` on the task's arguments (``"one"``), on each item of a
    chunk (``"map"``) or on each argument tuple of a chunk
    (``"starmap"``)."""

    def __init__(self, fn, mode: str, init, initargs: tuple, pool_id: str):
        self.fn = fn
        self.mode = mode
        self.init = init
        self.initargs = initargs
        self.pool_id = pool_id

    def __call__(self, *args, **kwargs):
        if self.init is not None and self.pool_id not in _initialized_pools:
            self.init(*self.initargs)  # a failed init is retried next task
            _initialized_pools.add(self.pool_id)
        if self.mode == "map":
            return [self.fn(x) for x in args[0]]
        if self.mode == "starmap":
            return [self.fn(*x) for x in args[0]]
        return self.fn(*args, **kwargs)


def _run(call: _PoolCall, *args, **kwargs):
    return call(*args, **kwargs)


_run_remote = ray_tpu_torch.remote(_run)


class AsyncResult:
    def __init__(self, refs, *, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout=None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout=None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs,
                                      num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            # the stdlib's contract: pending is not failure
            raise ValueError("AsyncResult not ready")
        try:
            self.get(timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class _FlatResult(AsyncResult):
    """The result of a chunked map: the chunks' lists, concatenated."""

    def get(self, timeout=None):
        nested = ray_tpu_torch.get(self._refs, timeout=timeout)
        return list(itertools.chain.from_iterable(nested))


class Pool:
    """Pool(processes): the runtime schedules by resources, so
    ``processes`` only bounds the chunking of ``map``."""

    def __init__(self, processes: int | None = None,
                 initializer: Callable | None = None, initargs=()):
        self._processes = processes or 8
        self._initializer = initializer
        self._initargs = tuple(initargs)
        self._closed = False
        self._pool_id = uuid.uuid4().hex

    # -- submission ------------------------------------------------------

    def _call(self, fn, mode: str = "one") -> _PoolCall:
        return _PoolCall(fn, mode, self._initializer, self._initargs,
                         self._pool_id)

    def _submit_chunks(self, fn, mode: str, items: list, chunksize) -> list:
        call = self._call(fn, mode)
        return [_run_remote.remote(call, c)
                for c in self._chunk(items, chunksize)]

    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        self._check_open()
        ref = _run_remote.remote(self._call(fn), *args, **(kwds or {}))
        return AsyncResult([ref], single=True)

    def map(self, fn, iterable: Iterable, chunksize: int | None = None):
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        self._check_open()
        return _FlatResult(
            self._submit_chunks(fn, "map", list(iterable), chunksize),
            single=False)

    def starmap(self, fn, iterable):
        refs = self._submit_chunks(fn, "starmap", list(iterable), None)
        return _FlatResult(refs, single=False).get()

    def imap(self, fn, iterable, chunksize: int | None = None):
        """Ordered iterator over results. Submission is EAGER (the
        stdlib's semantics: the pool may be closed while results are
        consumed); chunksize batches items a task."""
        self._check_open()
        refs = self._submit_chunks(fn, "map", list(iterable), chunksize)

        def gen():
            for ref in refs:
                yield from ray_tpu_torch.get(ref)

        return gen()

    def imap_unordered(self, fn, iterable, chunksize: int | None = None):
        self._check_open()
        refs = self._submit_chunks(fn, "map", list(iterable), chunksize)

        def gen():
            pending = list(refs)
            while pending:
                ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
                yield from ray_tpu_torch.get(ready[0])

        return gen()

    # -- lifecycle -------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        pass  # tasks are independent; nothing to join

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def _chunk(self, items: list, chunksize: int | None) -> list[list]:
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]
