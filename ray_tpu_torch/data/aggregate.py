"""Aggregations for ``Dataset.groupby`` and ``Dataset.aggregate``.

Port of ``ray_tpu/data/aggregate.py`` (reference:
``python/ray/data/aggregate.py``: ``AggregateFn``, ``Sum``, ``Min``,
``Max``, ``Mean``, ``Std``, ``Count``), in numpy over column-dict blocks.
Each aggregation is (partial per block, merge, finalize), so it composes
with the distributed groupby: per-block partials merged on the reduce
side.
"""

from __future__ import annotations

import numpy as np


class AggregateFn:
    """name: output column; on: input column (None for Count)."""

    name = "agg"

    def __init__(self, on: str | None = None, alias_name: str | None = None):
        self.on = on
        self.output_name = alias_name or (
            f"{self.name.lower()}({on})" if on else self.name.lower())

    # partial: computed per block; merge: combine partials; finalize: scalar
    def partial(self, values: np.ndarray):
        raise NotImplementedError

    def merge(self, a, b):
        raise NotImplementedError

    def finalize(self, partial):
        return partial


class Count(AggregateFn):
    name = "count"

    def partial(self, values):
        return int(len(values))

    def merge(self, a, b):
        return a + b


class Sum(AggregateFn):
    name = "sum"

    def partial(self, values):
        return np.sum(values)

    def merge(self, a, b):
        return a + b


class Min(AggregateFn):
    name = "min"

    def partial(self, values):
        return np.min(values)

    def merge(self, a, b):
        return min(a, b)


class Max(AggregateFn):
    name = "max"

    def partial(self, values):
        return np.max(values)

    def merge(self, a, b):
        return max(a, b)


class Mean(AggregateFn):
    name = "mean"

    def partial(self, values):
        return (np.sum(values), len(values))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, partial):
        s, n = partial
        return s / n if n else float("nan")


class Std(AggregateFn):
    """Numerically stable parallel variance (Chan et al. pairwise merge,
    the same scheme the reference's Std aggregate uses)."""

    name = "std"

    def __init__(self, on=None, alias_name=None, ddof: int = 1):
        super().__init__(on, alias_name)
        self.ddof = ddof

    def partial(self, values):
        v = np.asarray(values, dtype=np.float64)
        n = len(v)
        if n == 0:
            return (0, 0.0, 0.0)
        mean = float(np.mean(v))
        m2 = float(np.sum((v - mean) ** 2))
        return (n, mean, m2)

    def merge(self, a, b):
        na, ma, m2a = a
        nb, mb, m2b = b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        delta = mb - ma
        mean = ma + delta * nb / n
        m2 = m2a + m2b + delta * delta * na * nb / n
        return (n, mean, m2)

    def finalize(self, partial):
        n, _, m2 = partial
        d = n - self.ddof
        return float(np.sqrt(m2 / d)) if d > 0 else float("nan")
