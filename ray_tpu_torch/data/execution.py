"""Streaming executor: a pull-based operator pipeline with backpressure.

Port of ``ray_tpu/data/execution.py`` over the port's core API
(``ray_tpu_torch.put/get/wait/remote/kill``), on the in-process runtime
or a cluster (reference: ``python/ray/data/_internal/execution/``,
``StreamingExecutor`` at ``streaming_executor.py:49`` driving a topology
of physical operators; the scheduling loop is ``select_operator_to_run``,
``streaming_executor_state.py:376``: each tick, the runnable operator
with inputs and budget furthest downstream runs, which drains the
pipeline and bounds its memory). Backpressure is a cap on the bytes
resident in the topology (the reference budgets 25% of the object store,
``streaming_executor_state.py:39``).

Operators run the port's tasks (``MapOperator``, ``compute="tasks"``) or
a pool of reusable actors (``compute="actors"``), so expensive per-batch
state (a model on the card) is built once. A task's body is the
module-level ``_apply_task(kind, fn, *blocks)``: JAX submits a lambda
(``ray_tpu/data/execution.py:263-266``), which the port's cluster cannot
carry (it ships task bodies by stdlib pickle), so a pipeline of
module-level functions runs on ``init(address=)`` as well.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator

import ray_tpu_torch
from ray_tpu_torch.data.block import (BlockAccessor, batch_to_block,
                                      concat_blocks)


@dataclass
class RefBundle:
    """A unit of streamed data: object refs + size metadata."""

    refs: list                      # list[ObjectRef] of blocks
    num_rows: int = 0
    size_bytes: int = 0


@dataclass
class ExecutionOptions:
    max_in_flight_tasks: int = 8        # per operator
    max_buffered_bundles: int = 16      # per operator output queue
    actor_pool_size: int = 2
    # Byte budget for data resident in the topology (queued bundles +
    # in-flight task inputs). None = resolved from DataContext at
    # execution time (fraction of the object store). The most-downstream
    # runnable operator is always allowed to dispatch, so the pipeline
    # drains instead of deadlocking when one bundle exceeds the budget.
    max_in_flight_bytes: int | None = None


def _resolve_byte_budget(options: ExecutionOptions) -> int:
    if options.max_in_flight_bytes is not None:
        return options.max_in_flight_bytes
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    if ctx.execution_budget_bytes is not None:
        return ctx.execution_budget_bytes
    # As JAX: the in-process runtime's store has no stats(), so the budget
    # is a quarter of 1 GiB (256 MiB); a driver attached to a cluster reads
    # its node's shared-memory store, whose stats name "capacity".
    try:
        capacity = ray_tpu_torch.api._runtime().store.stats()["capacity"]
    except Exception:  # noqa: BLE001 - local mode / no store stats
        capacity = 1 << 30
    return max(int(capacity * ctx.execution_budget_fraction), 16 << 20)


class PhysicalOperator:
    """Base: pull input bundles, produce output bundles."""

    def __init__(self, name: str):
        from ray_tpu_torch.data.stats import OperatorStats

        self.name = name
        self.input_queue: deque[RefBundle] = deque()
        self.output_queue: deque[RefBundle] = deque()
        self.inputs_done = False
        self.metrics = {"bundles_in": 0, "bundles_out": 0, "tasks": 0}
        # per-operator execution stats (reference: DatasetStats,
        # data/_internal/stats.py) — filled by the executor as bundles
        # move, and by operators for task wall times
        self.stats = OperatorStats(name)

    # -- scheduling interface -------------------------------------------
    def can_accept_work(self, options: ExecutionOptions) -> bool:
        return (bool(self.input_queue)
                and len(self.output_queue) < options.max_buffered_bundles
                and self.num_active_tasks() < options.max_in_flight_tasks)

    def num_active_tasks(self) -> int:
        return 0

    def outstanding_bytes(self) -> int:
        """Bytes resident in this operator (queued + in-flight inputs) —
        the backpressure accounting unit."""
        return (sum(b.size_bytes for b in self.input_queue)
                + sum(b.size_bytes for b in self.output_queue))

    def dispatch(self, options: ExecutionOptions):
        raise NotImplementedError

    def poll(self):
        """Move finished task results to the output queue."""

    def is_done(self) -> bool:
        return (self.inputs_done and not self.input_queue
                and not self.output_queue and self.num_active_tasks() == 0)

    def all_dispatched(self) -> bool:
        return self.inputs_done and not self.input_queue

    def shutdown(self):
        pass


class InputDataOperator(PhysicalOperator):
    """Source: emits pre-materialized bundles (read tasks already refs)."""

    def __init__(self, bundles: list[RefBundle]):
        super().__init__("Input")
        self.output_queue.extend(bundles)
        self.inputs_done = True

    def can_accept_work(self, options):
        return False

    def dispatch(self, options):
        pass


def _apply_map(map_kind: str, fn, blocks: list):
    """Runs inside a task or actor: apply fn to the blocks."""
    out_blocks = []
    for block in blocks:
        acc = BlockAccessor.for_block(block)
        if map_kind == "batches":
            out = fn(acc.to_batch())
            out_blocks.append(batch_to_block(out))
        elif map_kind == "rows":
            out_blocks.append([fn(r) for r in acc.iter_rows()])
        elif map_kind == "flat":
            rows = []
            for r in acc.iter_rows():
                rows.extend(fn(r))
            out_blocks.append(rows)
        elif map_kind == "filter":
            out_blocks.append([r for r in acc.iter_rows() if fn(r)])
        else:
            raise ValueError(map_kind)
    merged = concat_blocks(out_blocks)
    acc = BlockAccessor.for_block(merged)
    return merged, acc.num_rows(), acc.size_bytes()


def _apply_task(map_kind: str, fn, *blocks):
    """The body of a map task (module level: stdlib pickle carries it, and
    ``fn`` by reference, to a cluster's workers)."""
    return _apply_map(map_kind, fn, list(blocks))


class _MapWorker:
    """Actor holding the map fn (a model built once survives across
    calls)."""

    def __init__(self, map_kind: str, fn_factory):
        self._kind = map_kind
        self._fn = fn_factory() if callable(fn_factory) else fn_factory

    def apply(self, *blocks):
        return _apply_map(self._kind, self._fn, list(blocks))


class MapOperator(PhysicalOperator):
    """Task- or actor-pool map over blocks (MapOperator/TaskPool/ActorPool
    analogs). compute="tasks" | "actors".

    Actor pools AUTOSCALE: during execution the pool grows from
    ``actor_pool_size`` up to ``max_actor_pool_size`` while queued work
    outruns it (reference: ``ActorPoolMapOperator`` +
    ``AutoscalingPolicy``); once the operator's input is DRAINED, idle
    actors retire immediately — the pool is ending anyway, and their
    resources unblock downstream operators."""

    def __init__(self, name: str, map_kind: str, fn,
                 compute: str = "tasks", num_cpus: float = 1,
                 actor_pool_size: int = 2,
                 max_actor_pool_size: int | None = None):
        super().__init__(name)
        self.map_kind = map_kind
        self.fn = fn
        self.compute = compute
        self.num_cpus = num_cpus
        self.actor_pool_size = actor_pool_size
        self.max_actor_pool_size = (max_actor_pool_size
                                    or max(actor_pool_size, 8))
        self._active: list[tuple] = []   # (result_ref, bundle, serial|None)
        self._pool: list = []               # (serial, actor) entries
        # load keyed by pool SERIAL, not id(actor): a killed actor's
        # handle can be garbage-collected and its id() reused by a new
        # spawn, so a late poll() decrement for the old actor would hit
        # the new one and drive its in-flight count negative
        self._pool_load: dict = {}          # serial -> in-flight count
        self._pool_serial = 0
        self._task = None                   # the map task, made at first use

    def num_active_tasks(self) -> int:
        return len(self._active)

    def outstanding_bytes(self) -> int:
        return (super().outstanding_bytes()
                + sum(entry[1].size_bytes for entry in self._active))

    def _spawn_actor(self):
        worker_cls = ray_tpu_torch.remote(_MapWorker)
        actor = worker_cls.options(num_cpus=self.num_cpus).remote(
            self.map_kind, self.fn)
        self._pool_serial += 1
        self._pool.append((self._pool_serial, actor))
        self._pool_load[self._pool_serial] = 0
        self.metrics["actors_started"] = (
            self.metrics.get("actors_started", 0) + 1)
        return actor

    def _ensure_pool(self):
        if self._pool or self.compute != "actors":
            return
        for _ in range(self.actor_pool_size):
            self._spawn_actor()

    def _scale_up(self):
        """Every actor busy AND input still queued → add one (up to
        max). Runs at dispatch time only."""
        busy = all(self._pool_load.get(s, 0) > 0 for s, _ in self._pool)
        if (self.input_queue and busy
                and len(self._pool) < self.max_actor_pool_size):
            self._spawn_actor()

    def _scale_down(self):
        """Input drained → retire idle actors (the operator is winding
        down; resources free up for downstream work). Runs at poll time
        only — scale-down at dispatch time could empty the pool with a
        bundle already popped and waiting for an actor."""
        if not self.all_dispatched():
            return
        for entry in [e for e in self._pool
                      if self._pool_load.get(e[0], 0) == 0]:
            self._pool.remove(entry)
            self._pool_load.pop(entry[0], None)
            try:
                ray_tpu_torch.kill(entry[1])
            except Exception:  # noqa: BLE001
                pass

    def dispatch(self, options: ExecutionOptions):
        if not self.input_queue:
            return
        bundle = self.input_queue.popleft()
        self.metrics["bundles_in"] += 1
        self.metrics["tasks"] += 1
        if self.compute == "actors":
            self._ensure_pool()
            if not self._pool:   # fully retired by a previous drain tick
                self._spawn_actor()
            self._scale_up()
            # least-loaded actor (reference: the pool picks by queue depth)
            serial, actor = min(
                self._pool, key=lambda e: self._pool_load.get(e[0], 0))
            self._pool_load[serial] = self._pool_load.get(serial, 0) + 1
            ref = actor.apply.remote(*bundle.refs)
            self._active.append((ref, bundle, serial, time.monotonic()))
            return
        if self._task is None:
            self._task = ray_tpu_torch.remote(_apply_task).options(
                num_cpus=self.num_cpus)
        ref = self._task.remote(self.map_kind, self.fn, *bundle.refs)
        self._active.append((ref, bundle, None, time.monotonic()))

    def poll(self):
        still = []
        for ref, bundle, owner, submit_t in self._active:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if ready:
                block, rows, nbytes = ray_tpu_torch.get(ref)
                if len(self.stats.task_wall_s) < 10_000:
                    self.stats.task_wall_s.append(
                        time.monotonic() - submit_t)
                if owner is not None and owner in self._pool_load:
                    self._pool_load[owner] -= 1
                for out_block, out_rows, out_bytes in _maybe_split(
                        block, rows, nbytes):
                    self.output_queue.append(RefBundle(
                        [ray_tpu_torch.put(out_block)], num_rows=out_rows,
                        size_bytes=out_bytes))
                self.metrics["bundles_out"] += 1
            else:
                still.append((ref, bundle, owner, submit_t))
        self._active = still
        if self.compute == "actors" and self._pool:
            self._scale_down()

    def shutdown(self):
        for _, actor in self._pool:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001
                pass
        self._pool = []


def _maybe_split(block, rows: int, nbytes: int):
    """Size-based block splitting (reference: DataContext
    target_max_block_size + output splitting in MapOperator): an
    oversized map output becomes several row-sliced blocks so one fat
    block can't blow the byte budget or a downstream consumer's memory."""
    from ray_tpu_torch.data.context import DataContext

    target = DataContext.get_current().target_max_block_size
    if nbytes <= target or rows <= 1:
        return [(block, rows, nbytes)]
    n_chunks = min(rows, -(-nbytes // target))
    per = -(-rows // n_chunks)
    acc = BlockAccessor.for_block(block)
    out = []
    for start in range(0, rows, per):
        piece = acc.slice(start, min(start + per, rows))
        pacc = BlockAccessor.for_block(piece)
        out.append((piece, pacc.num_rows(), pacc.size_bytes()))
    return out


class AllToAllOperator(PhysicalOperator):
    """Barrier operator (shuffle/sort/repartition): consumes ALL input
    bundles, then emits transformed bundles. Reference: push-based shuffle
    scheduler (_internal/planner/exchange/)."""

    def __init__(self, name: str,
                 transform: Callable[[list[RefBundle]], list[RefBundle]]):
        super().__init__(name)
        self.transform = transform
        self._collected: list[RefBundle] = []
        self._emitted = False

    def can_accept_work(self, options) -> bool:
        # collection is cheap — always drain inputs; the barrier fires when
        # upstream is done
        return bool(self.input_queue) or (
            self.inputs_done and not self._emitted)

    def dispatch(self, options: ExecutionOptions):
        while self.input_queue:
            self._collected.append(self.input_queue.popleft())
            self.metrics["bundles_in"] += 1
        if self.inputs_done and not self._emitted:
            self._emitted = True
            for b in self.transform(self._collected):
                self.output_queue.append(b)
                self.metrics["bundles_out"] += 1

    def is_done(self) -> bool:
        return self._emitted and not self.output_queue


class LimitOperator(PhysicalOperator):
    def __init__(self, limit: int):
        super().__init__(f"Limit[{limit}]")
        self.remaining = limit

    def can_accept_work(self, options) -> bool:
        return bool(self.input_queue)

    def dispatch(self, options: ExecutionOptions):
        while self.input_queue:
            bundle = self.input_queue.popleft()
            if self.remaining <= 0:
                continue
            if bundle.num_rows <= self.remaining:
                self.remaining -= bundle.num_rows
                self.output_queue.append(bundle)
            else:
                block = concat_blocks(ray_tpu_torch.get(list(bundle.refs)))
                acc = BlockAccessor.for_block(block)
                sliced = acc.slice(0, self.remaining)
                self.remaining = 0
                sacc = BlockAccessor.for_block(sliced)
                self.output_queue.append(RefBundle(
                    [ray_tpu_torch.put(sliced)], num_rows=sacc.num_rows(),
                    size_bytes=sacc.size_bytes()))


class StreamingExecutor:
    """Drives a linear operator topology to completion, yielding output
    bundles as they materialize (results stream while upstream still runs).
    """

    def __init__(self, operators: list[PhysicalOperator],
                 options: ExecutionOptions | None = None):
        from ray_tpu_torch.data.stats import DatasetStats

        self.operators = operators
        self.options = options or ExecutionOptions()
        self._byte_budget = _resolve_byte_budget(self.options)
        self.stats = DatasetStats()
        self.stats.operators = [op.stats for op in operators]

    @staticmethod
    def _note_moved(up: PhysicalOperator, down: PhysicalOperator | None,
                    bundle: RefBundle):
        now = time.monotonic()
        s = up.stats
        if s.first_activity is None:
            s.first_activity = now
        s.last_activity = now
        s.bundles_out += 1
        s.bytes_out += bundle.size_bytes
        s.rows_out += bundle.num_rows
        if down is not None:
            d = down.stats
            if d.first_activity is None:
                d.first_activity = now
            d.last_activity = now
            d.bundles_in += 1
            d.bytes_in += bundle.size_bytes

    def execute(self) -> Iterator[RefBundle]:
        ops = self.operators
        try:
            while True:
                progressed = False
                # propagate bundles + doneness downstream
                for i in range(len(ops) - 1):
                    up, down = ops[i], ops[i + 1]
                    while up.output_queue:
                        bundle = up.output_queue.popleft()
                        self._note_moved(up, down, bundle)
                        down.input_queue.append(bundle)
                        progressed = True
                    if up.is_done() and not down.inputs_done:
                        down.inputs_done = True
                        progressed = True
                # stream final outputs
                tail = ops[-1]
                while tail.output_queue:
                    progressed = True
                    bundle = tail.output_queue.popleft()
                    self._note_moved(tail, None, bundle)
                    yield bundle
                if tail.is_done():
                    return
                # pick operators to run: furthest-downstream first
                # (select_operator_to_run analog). Byte-budget admission
                # (_execution_allowed analog): once the topology holds
                # more than the budget, only the most-downstream runnable
                # operator may dispatch — it shrinks the resident set;
                # upstream dispatch would grow it.
                over_budget = (sum(op.outstanding_bytes() for op in ops)
                               > self._byte_budget)
                drained_one = False
                for op in reversed(ops):
                    op.poll()
                    while op.can_accept_work(self.options):
                        if over_budget and drained_one:
                            break
                        op.dispatch(self.options)
                        drained_one = True
                        progressed = True
                if not progressed:
                    time.sleep(0.002)
        finally:
            self.stats.end_t = time.monotonic()
            for op in ops:
                op.stats.tasks = op.metrics.get("tasks", 0)
                op.shutdown()
