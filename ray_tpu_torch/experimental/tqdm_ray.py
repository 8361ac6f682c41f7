"""Distributed progress bars.

Reference analog: ``python/ray/experimental/tqdm_ray.py``: tqdm-like
bars whose updates flow from remote tasks and actors to one named
aggregator actor, so concurrent workers don't corrupt the terminal.
"""

from __future__ import annotations

import sys
import threading
import time
import uuid

import ray_tpu_torch

_AGGREGATOR_NAME = "__tqdm_ray_aggregator"


class _Aggregator:
    def __init__(self):
        self.bars: dict[str, dict] = {}
        self.lock = threading.Lock()

    def update(self, bar_id: str, desc: str, total, n: int):
        with self.lock:
            bar = self.bars.setdefault(
                bar_id, {"desc": desc, "total": total, "n": 0})
            bar["n"] += n
            bar["total"] = total
            return dict(bar)

    def close_bar(self, bar_id: str):
        with self.lock:
            return self.bars.pop(bar_id, None)

    def snapshot(self):
        with self.lock:
            return {k: dict(v) for k, v in self.bars.items()}


def _aggregator():
    try:
        return ray_tpu_torch.get_actor(_AGGREGATOR_NAME)
    except ValueError:
        cls = ray_tpu_torch.remote(_Aggregator)
        try:
            # a serial actor: each caller's submission order is its
            # execution order, so a snapshot() submitted after a burst of
            # fire-and-forget update()s observes all of them
            return cls.options(name=_AGGREGATOR_NAME).remote()
        except ValueError:
            return ray_tpu_torch.get_actor(_AGGREGATOR_NAME)


class tqdm:  # noqa: N801 - mirrors the tqdm API name
    """Works inside remote tasks: updates aggregate on the named actor;
    rendering happens wherever ``render`` runs (the driver)."""

    def __init__(self, iterable=None, *, desc: str = "", total=None,
                 position: int = 0):
        self._iterable = iterable
        self.desc = desc or "progress"
        self.total = total if total is not None else (
            len(iterable) if iterable is not None and
            hasattr(iterable, "__len__") else None)
        self._id = uuid.uuid4().hex[:12]
        self._agg = _aggregator()

    def update(self, n: int = 1):
        # fire-and-forget: a blocking get per element would serialize the
        # wrapped loop on the actor's round trip
        self._agg.update.remote(self._id, self.desc, self.total, n)

    def close(self):
        ray_tpu_torch.get(self._agg.close_bar.remote(self._id))

    def __iter__(self):
        try:
            for x in self._iterable:
                yield x
                self.update(1)
        finally:
            # a break or an exception still retires the bar from the
            # long-lived aggregator
            self.close()


def snapshot() -> dict:
    """Every live bar's state (what ``render`` draws)."""
    return ray_tpu_torch.get(_aggregator().snapshot.remote())


def render(stream=None, *, clear: bool = False):
    """One textual render of every live bar."""
    stream = stream or sys.stderr
    lines = []
    for bar in snapshot().values():
        total = bar["total"]
        n = bar["n"]
        if total:
            fill = int(min(1.0, n / total) * 20)
            lines.append(f"{bar['desc']}: |{'#' * fill}{'-' * (20 - fill)}| "
                         f"{n}/{total}")
        else:
            lines.append(f"{bar['desc']}: {n} it")
    out = "\n".join(lines)
    if out:
        stream.write(out + "\n")
    return out


def watch(interval: float = 0.5, *, duration: float = 5.0):
    """Poll and render until no bar is live or ``duration`` passes."""
    deadline = time.monotonic() + duration
    while time.monotonic() < deadline:
        if not snapshot():
            return
        render()
        time.sleep(interval)
