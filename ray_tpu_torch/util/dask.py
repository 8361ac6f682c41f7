"""Dask on ray_tpu_torch: execute dask task graphs on the runtime.

Reference analog: ``python/ray/util/dask/scheduler.py`` —
``ray_dask_get`` walks a dask graph and submits one ray task per graph
task, passing upstream results as ObjectRefs so the object plane (not
the driver) carries intermediate data. This implementation speaks the
dask graph *protocol* directly (a graph is a dict of key -> literal |
key | ``(callable, *args)`` with keys/nested lists inside args), so the
scheduler core works, and is tested, without dask installed; when
dask IS present, ``enable_dask_on_ray`` registers it as the default
``dask.config`` scheduler exactly like the reference. On a cluster a
graph's callables reach the workers by stdlib pickle, so they are
module-level ones there.
"""

from __future__ import annotations

from typing import Any, Hashable

import ray_tpu_torch

__all__ = ["ray_dask_get", "enable_dask_on_ray"]


def _ishashable(x) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def _istask(x) -> bool:
    """Dask task spec: a tuple whose head is callable."""
    return isinstance(x, tuple) and bool(x) and callable(x[0])


class _Dep:
    """Placeholder for the i-th dependency inside a shipped expression
    (rebuilt executor-side from the materialized top-level args)."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _rebuild(expr, deps):
    """Executor-side: run a task expression with deps substituted."""
    if isinstance(expr, _Dep):
        return deps[expr.i]
    if _istask(expr):
        fn = expr[0]
        return fn(*[_rebuild(a, deps) for a in expr[1:]])
    if isinstance(expr, list):
        return [_rebuild(a, deps) for a in expr]
    if isinstance(expr, tuple):
        return tuple(_rebuild(a, deps) for a in expr)
    if isinstance(expr, dict):
        return {k: _rebuild(v, deps) for k, v in expr.items()}
    return expr


def _exec_task(expr, *deps):
    return _rebuild(expr, deps)


def ray_dask_get(dsk: dict, keys, ray_remote_args: dict | None = None,
                 **kwargs) -> Any:
    """Dask scheduler entry point (``dask.compute(scheduler=ray_dask_get)``
    or direct use). ``keys`` may be a single key or (nested) lists of
    keys; the result mirrors its structure. Each graph task becomes one
    cluster task; shared upstream keys are computed once and fan out as
    ObjectRefs."""
    remote = ray_tpu_torch.remote(**(ray_remote_args or {}))(_exec_task) \
        if ray_remote_args else _exec_remote
    refs: dict[Hashable, Any] = {}     # key -> ObjectRef | literal
    visiting: set = set()

    def schedule(key):
        if key in refs:
            return refs[key]
        if key in visiting:
            raise ValueError(f"cycle in dask graph at key {key!r}")
        visiting.add(key)
        expr = dsk[key]
        try:
            if _istask(expr):
                shipped, deps = _extract(expr)
                refs[key] = remote.remote(shipped, *deps)
            elif _ishashable(expr) and expr in dsk and expr != key:
                refs[key] = schedule(expr)          # alias key
            elif isinstance(expr, (list, tuple, dict)) and _has_keys(expr):
                shipped, deps = _extract(expr)
                refs[key] = remote.remote(shipped, *deps)
            else:
                refs[key] = expr                    # plain literal
        finally:
            visiting.discard(key)
        return refs[key]

    def _has_keys(expr) -> bool:
        if _ishashable(expr) and expr in dsk:
            return True
        if isinstance(expr, (list, tuple)):
            return any(_has_keys(a) for a in expr)
        if isinstance(expr, dict):
            return any(_has_keys(v) for v in expr.values())
        return False

    def _extract(expr):
        """Replace graph-key references inside ``expr`` with _Dep
        placeholders; the keys' refs travel as TOP-LEVEL task args (the
        runtime materializes top-level ObjectRefs, same contract as the
        reference scheduler's unpack_object_refs)."""
        deps: list = []

        def walk(e):
            if _ishashable(e) and e in dsk:
                deps.append(schedule(e))
                return _Dep(len(deps) - 1)
            if _istask(e):
                return (e[0],) + tuple(walk(a) for a in e[1:])
            if isinstance(e, list):
                return [walk(a) for a in e]
            if isinstance(e, tuple):
                return tuple(walk(a) for a in e)
            if isinstance(e, dict):
                return {k: walk(v) for k, v in e.items()}
            return e

        return walk(expr), deps

    def resolve(k):
        if isinstance(k, list):
            return [resolve(x) for x in k]
        out = schedule(k)
        return ray_tpu_torch.get(out) if isinstance(
            out, ray_tpu_torch.ObjectRef) else out

    return resolve(keys)


_exec_remote = ray_tpu_torch.remote(_exec_task)


def enable_dask_on_ray(**dask_config_kwargs):
    """Set ``ray_dask_get`` as dask's default scheduler (requires dask;
    the scheduler itself does not). Usable as a context manager, like
    the reference helper."""
    try:
        import dask
    except ImportError as e:                       # pragma: no cover
        raise ImportError(
            "enable_dask_on_ray requires dask; ray_dask_get itself "
            "works without it") from e
    return dask.config.set(scheduler=ray_dask_get, **dask_config_kwargs)
