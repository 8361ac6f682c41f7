"""ActorPool (reference API: ``python/ray/util/actor_pool.py:13``). Work
is tracked by a submission serial, with a deque of queued calls and one
in-flight table keyed both ways."""

from __future__ import annotations

from collections import deque

import ray_tpu_torch
from ray_tpu_torch.utils.exceptions import GetTimeoutError


class ActorPool:
    """Round-robin work distribution over a fixed set of actors, with
    results in submission order (``map``) or completion order
    (``map_unordered``)."""

    def __init__(self, actors: list):
        self._idle = deque(actors)
        self._queued: deque = deque()      # (fn, value) waiting for an actor
        self._in_flight: dict = {}         # serial -> (ref, actor)
        self._serial_of: dict = {}         # ref -> serial
        self._submitted = 0                # serials handed out
        self._yielded = 0                  # next serial get_next() returns

    # -- submission ----------------------------------------------------

    def submit(self, fn, value):
        """fn(actor, value) -> ObjectRef; queued if all actors are busy."""
        if self._idle:
            self._launch(fn, value)
        else:
            self._queued.append((fn, value))

    def _launch(self, fn, value):
        actor = self._idle.popleft()
        ref = fn(actor, value)
        self._in_flight[self._submitted] = (ref, actor)
        self._serial_of[ref] = self._submitted
        self._submitted += 1

    def _recycle(self, serial):
        ref, actor = self._in_flight.pop(serial)
        self._serial_of.pop(ref, None)
        self._idle.append(actor)
        if self._queued:
            self._launch(*self._queued.popleft())

    # -- results -------------------------------------------------------

    def has_next(self) -> bool:
        return bool(self._in_flight) or bool(self._queued)

    def get_next(self, timeout=None):
        """The next result in SUBMISSION order."""
        # slots consumed out of order by get_next_unordered leave holes;
        # the in-order cursor walks past them
        while (self._yielded < self._submitted
               and self._yielded not in self._in_flight):
            self._yielded += 1
        if self._yielded not in self._in_flight:
            raise StopIteration("no pending results")
        serial = self._yielded
        ref = self._in_flight[serial][0]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            # nothing consumed: the same serial is retrievable on retry,
            # and the still-busy actor is NOT recycled
            raise
        except BaseException:
            # the task failed but the actor is healthy: consume the slot
            # and recycle it, so queued submits aren't stranded
            self._yielded = serial + 1
            self._recycle(serial)
            raise
        self._yielded = serial + 1
        self._recycle(serial)
        return value

    def get_next_unordered(self, timeout=None):
        """The next result in COMPLETION order."""
        if not self._in_flight:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(
            [r for r, _ in self._in_flight.values()], num_returns=1,
            timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        serial = self._serial_of[ref]
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._recycle(serial)

    def map(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- manual actor management ---------------------------------------

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._idle.append(actor)
