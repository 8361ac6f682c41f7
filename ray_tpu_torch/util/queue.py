"""Distributed Queue (reference: ``python/ray/util/queue.py:20``): an
actor-backed FIFO shared across tasks, actors and drivers."""

from __future__ import annotations

import time
from collections import deque

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def qsize(self):
        return len(self.items)

    def put_nowait(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_nowait_batch(self, items) -> bool:
        if self.maxsize > 0 and len(self.items) + len(items) > self.maxsize:
            return False
        self.items.extend(items)
        return True

    def get_nowait(self):
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def get_nowait_batch(self, n: int):
        out = []
        while self.items and len(out) < n:
            out.append(self.items.popleft())
        return out


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, item, block: bool = True, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait_batch(self, items):
        if not ray_tpu_torch.get(
                self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    def get_nowait_batch(self, n: int):
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(n))

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)
