"""Parallel iterators over sharded data.

Reference analog: ``python/ray/util/iter.py``: ``ParallelIterator``, its
shards held by actors, lazy transforms, gathered into a local iterator.
Ray Data supersedes it in the reference; it is kept for API parity and
for light actor-sharded iteration without the Dataset machinery. On a
cluster the transforms reach the shard actors by stdlib pickle, so they
are module-level functions there.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import ray_tpu_torch


class _ShardActor:
    def __init__(self, items: list):
        self.items = list(items)

    def materialize(self, ops: list) -> list:
        out = list(self.items)
        for kind, fn in ops:
            if kind == "map":
                out = [fn(x) for x in out]
            elif kind == "filter":
                out = [x for x in out if fn(x)]
            elif kind == "flatten":
                out = [y for x in out for y in fn(x)]
            elif kind == "batch":
                n = fn
                out = [out[i:i + n] for i in range(0, len(out), n)]
        return out


# the class stays importable by its own name, so pickle finds it
_shard_actor = ray_tpu_torch.remote(_ShardActor)


class ParallelIterator:
    """Transforms are recorded on the caller's side and shipped at gather
    time, so each transform returns a NEW iterator: two iterators
    branched from one parent never share an op chain (the reference API's
    value semantics)."""

    def __init__(self, shards: list, ops: tuple = ()):
        self._shards = shards
        self._ops = ops

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    # -- lazy transforms -------------------------------------------------

    def _with(self, kind: str, fn) -> "ParallelIterator":
        return ParallelIterator(self._shards, self._ops + ((kind, fn),))

    def for_each(self, fn: Callable) -> "ParallelIterator":
        return self._with("map", fn)

    def filter(self, fn: Callable) -> "ParallelIterator":
        return self._with("filter", fn)

    def flat_map(self, fn: Callable) -> "ParallelIterator":
        return self._with("flatten", fn)

    def batch(self, n: int) -> "ParallelIterator":
        return self._with("batch", n)

    # -- consumption -----------------------------------------------------

    def gather_sync(self):
        """Round-robin merge of all shards into one local iterator."""
        ops = list(self._ops)
        lists = ray_tpu_torch.get([s.materialize.remote(ops)
                                   for s in self._shards])
        iters = [iter(x) for x in lists]
        while iters:
            nxt = []
            for it in iters:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            iters = nxt

    def gather_async(self):
        """Shard-major merge (whole shards as they complete)."""
        ops = list(self._ops)
        pending = [s.materialize.remote(ops) for s in self._shards]
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    def take(self, n: int) -> list:
        out = []
        for x in self.gather_sync():
            out.append(x)
            if len(out) >= n:
                break
        return out

    def shards(self) -> list:
        return list(self._shards)


def from_items(items: list, num_shards: int = 2) -> ParallelIterator:
    items = list(items)
    return ParallelIterator([_shard_actor.remote(items[i::num_shards])
                             for i in range(num_shards)])


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)


def from_iterators(iterables: list[Iterable[Any]]) -> ParallelIterator:
    return ParallelIterator(
        [_shard_actor.remote(list(it)) for it in iterables])
