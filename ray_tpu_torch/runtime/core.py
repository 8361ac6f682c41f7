"""The in-process runtime: submission, ownership, scheduling, execution.

Port of the local mode of ``ray_tpu/runtime/core.py`` (reference: the
core_worker + raylet pair, ``src/ray/core_worker/core_worker.cc`` +
``src/ray/raylet/``): a dependency manager gates tasks on their arguments
(reference ``transport/dependency_resolver.cc``), a dispatcher accounts
resources and hands ready tasks to a thread pool (reference
``LocalTaskManager``), actors get dedicated ordered executors (reference
``DirectActorTaskSubmitter`` + ``ActorSchedulingQueue``), async actors run
their coroutines on one shared event loop, and failures flow through retry
bookkeeping (reference ``TaskManager::RetryTaskIfPossible``,
``task_manager.h:369``).

Everything runs in this process, on threads. The cluster backend, which
runs tasks and actors in worker processes, is ``runtime/driver.py``'s
``ClusterRuntime`` (``init(address=...)``). Runtime environments apply
in-process as in JAX: their paths are added to ``sys.path`` and their
``env_vars`` overlay ``os.environ`` for the task's duration, one such task
at a time. Not ported here: the task timeline and counters and the trace
spans (the observability planes); each waits for its slice.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.runtime.object_ref import ObjectRef
from ray_tpu_torch.runtime.object_store import ObjectStore
from ray_tpu_torch.runtime.task_spec import ResourceSet, TaskSpec, TaskType
from ray_tpu_torch.utils import exceptions as exc
from ray_tpu_torch.utils.config import Config, get_config
from ray_tpu_torch.utils.ids import ActorID, JobID, NodeID, ObjectID, TaskID, _Counter


# Serializes tasks that declare env_vars (reference: each runtime_env
# gets its own worker PROCESS — worker_pool.cc env-keyed caching; the
# in-process local runtime approximates that by scoping os.environ
# mutations under one lock so concurrent tasks never see each other's
# vars half-applied). The lock is SUSPENDED while its holder blocks in
# get()/wait() (see _note_worker_blocked) — otherwise a task with
# env_vars waiting on a child that also has env_vars deadlocks.
_runtime_env_lock = threading.Lock()


class _EnvVarSession:
    """One task execution's os.environ overlay; suspendable."""

    def __init__(self, env_vars: dict):
        self.env_vars = env_vars
        self.old: dict | None = None
        self.held = False

    def acquire(self):
        _runtime_env_lock.acquire()
        self.held = True
        self.old = {k: os.environ.get(k) for k in self.env_vars}
        os.environ.update(self.env_vars)

    def release(self):
        if not self.held:
            return
        for k, v in (self.old or {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.held = False
        _runtime_env_lock.release()


def _isawaitable(x) -> bool:
    import inspect

    return inspect.isawaitable(x)


# ---------------------------------------------------------------------------
# Actor bookkeeping
# ---------------------------------------------------------------------------

@dataclass
class ActorState:
    actor_id: ActorID
    name: str | None
    namespace: str = "default"
    instance: Any = None
    dead: bool = False
    death_reason: str = ""
    max_restarts: int = 0
    num_restarts: int = 0
    creation_spec: TaskSpec | None = None
    # Ordered execution: a dedicated single-thread (or N-thread) executor.
    executor: ThreadPoolExecutor | None = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    # In-order dispatch (reference: SequentialActorSubmitQueue +
    # ActorSchedulingQueue): tasks are sequenced at submission and dispatched
    # to the executor strictly in sequence order, even if an earlier call's
    # argument dependencies resolve after a later call's.
    submit_seq: _Counter = field(default_factory=_Counter)
    next_to_dispatch: int = 1
    seq_buffer: dict[int, TaskSpec] = field(default_factory=dict)
    # Tasks handed to the executor but not yet completed (for kill cleanup).
    in_flight: dict[TaskID, TaskSpec] = field(default_factory=dict)
    # ASYNC actors: concurrency bound for coroutine methods scheduled on
    # the runtime's shared event loop (created lazily on that loop)
    async_sem: Any = None


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

class Runtime:
    """Singleton runtime: object store + scheduler + actor registry."""

    def __init__(self, config: Config | None = None,
                 resources: dict | None = None,
                 namespace: str | None = None):
        self.config = config or get_config()
        self.job_id = JobID.from_random()
        # named actors scope to a namespace; default = this job's id
        # (reference: worker.py:1157 — anonymous namespaces isolate jobs)
        self.namespace = namespace or f"job-{self.job_id.hex()[:12]}"
        self.node_id = NodeID.from_random()
        self.store = ObjectStore()

        # --- resource accounting (reference: LocalResourceManager) ---
        ncpu = float(os.cpu_count() or 1)
        self.total_resources: dict[str, float] = {"CPU": ncpu, "memory": 0.0}
        if resources:
            self.total_resources.update({k: float(v) for k, v in resources.items()})
        self.available_resources = dict(self.total_resources)
        self._res_lock = threading.Lock()
        self._res_cv = threading.Condition(self._res_lock)

        # --- dependency manager ---
        self._dep_lock = threading.Lock()
        # object id -> list of task specs blocked on it
        self._waiting_on: dict[ObjectID, list[TaskSpec]] = {}
        # task id -> set of unresolved dep ids
        self._unresolved: dict[TaskID, set[ObjectID]] = {}
        self.store.subscribe_put(self._on_object_available)

        # --- dispatch queue + worker pool ---
        # Size from the CPU *resource* (the logical cluster), not just host
        # cores: init(num_cpus=8) on a 4-core host must still run 8
        # concurrent tasks (reference: worker pool scales with resource
        # demand, not cores — worker_pool.cc prestart).
        nworkers = self.config.num_workers or int(
            max(ncpu, self.total_resources.get("CPU", 0.0)))
        self._ready: deque[TaskSpec] = deque()
        self._ready_cv = threading.Condition()
        # Feasible-but-busy tasks parked until resources free up (reference:
        # LocalTaskManager's waiting queue; avoids head-of-line blocking).
        self._blocked: deque[TaskSpec] = deque()
        # Future waiters keyed by object id (as_future resolution, threadless).
        self._future_waiters: dict[ObjectID, list[Future]] = {}
        self._base_workers = max(4, nworkers)
        self._pool = ThreadPoolExecutor(
            max_workers=self._base_workers,
            thread_name_prefix="ray_tpu-worker",
        )
        # Blocked-worker relief (reference: a worker blocked in ray.get
        # releases its slot so the raylet can lease new workers —
        # worker_pool prestart on blocked leases). Pool threads blocked in
        # get() keep occupying their thread, so the dispatcher runs tasks
        # on overflow threads whenever every pool thread is taken, up to a
        # cap. Without this, N tasks that all wait on a child task/actor
        # deadlock an N-thread pool.
        self._pool_cap = max(64, 4 * self._base_workers)
        self._thread_acct = threading.Lock()
        self._inflight_pool = 0      # submitted to pool, not yet finished
        self._overflow_threads = 0   # live overflow threads
        # Per-worker-thread execution state (current spec, block depth)
        # used by the blocked-worker protocol above.
        self._exec_tl = threading.local()
        self._shutdown = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="ray_tpu-dispatcher", daemon=True
        )
        self._dispatcher.start()

        # --- actors ---
        self._actors: dict[ActorID, ActorState] = {}
        self._named_actors: dict[str, ActorID] = {}
        self._actor_lock = threading.Lock()

        # --- cancellation ---
        self._cancelled: set[TaskID] = set()
        self._return_owner: dict[ObjectID, TaskID] = {}

        # --- reference counting (local mode: immediate in-process
        # release; see runtime/refcount.py) ---
        from ray_tpu_torch.runtime.refcount import global_counter as _refs
        self._refs = _refs
        self._ref_enabled = self.config.ref_counting_enabled
        # released-before-created oids (fire-and-forget returns): freed
        # the moment the producing task stores them
        self._released_oids: set[ObjectID] = set()
        if self._ref_enabled:
            self._refs.set_local_release(self._on_ref_zero)
            threading.Thread(target=self._ref_poll_loop, daemon=True,
                             name="ref-poller").start()

    def _ref_poll_loop(self):
        while not self._shutdown:
            time.sleep(0.05)
            self._refs.poll_local()

    def _on_ref_zero(self, oid_hex: str):
        """No live ObjectRef instance anywhere in this process: free the
        stored value (or arrange free-on-arrival for a result whose task
        is still running — fire-and-forget returns). Marked BEFORE the
        store check: an object arriving in between is caught by either
        this free or _on_object_available's released check (free is
        idempotent; both sides discard the mark)."""
        oid = ObjectID.from_hex(oid_hex)
        self._released_oids.add(oid)
        while len(self._released_oids) > 1_000_000:
            self._released_oids.pop()
        if self.store.contains(oid):
            self._released_oids.discard(oid)
            self.store.free([oid])

    # ------------------------------------------------------------------
    # Public object API
    # ------------------------------------------------------------------

    def put(self, value) -> ObjectRef:
        oid = ObjectID.from_random()
        self.store.put(oid, value)
        return ObjectRef(oid)

    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list[Any]:
        ids = [r.id for r in refs]
        blocked = any(not self.store.contains(i) for i in ids)
        if blocked:
            self._note_worker_blocked()
        try:
            return self.store.get(ids, timeout=timeout)
        finally:
            if blocked:
                self._note_worker_unblocked()

    def _submit_to_workers(self, spec: TaskSpec):
        """Run a ready task on the pool, or on an overflow thread when
        every pool thread is taken (busy OR parked in a blocking get —
        either way the thread is occupied). Uses only public executor
        API; overflow is bounded by _pool_cap."""
        with self._thread_acct:
            overflow = (
                self._inflight_pool >= self._base_workers
                and (self._base_workers + self._overflow_threads)
                < self._pool_cap
            )
            if overflow:
                self._overflow_threads += 1
            else:
                self._inflight_pool += 1
        if overflow:
            threading.Thread(
                target=self._execute_overflow, args=(spec,),
                name="ray_tpu-worker-overflow", daemon=True,
            ).start()
        else:
            self._pool.submit(self._execute_pooled, spec)

    def _execute_pooled(self, spec: TaskSpec):
        try:
            self._execute_task(spec)
        finally:
            with self._thread_acct:
                self._inflight_pool -= 1

    def _execute_overflow(self, spec: TaskSpec):
        try:
            self._execute_task(spec)
        finally:
            with self._thread_acct:
                self._overflow_threads -= 1

    def _call_in_runtime_env(self, runtime_env, fn, args, kwargs):
        if not runtime_env:
            return fn(*args, **kwargs)
        from ray_tpu_torch.runtime_env import apply_paths

        apply_paths(runtime_env)
        env_vars = runtime_env.get("env_vars")
        if not env_vars:
            return fn(*args, **kwargs)
        tl = self._exec_tl
        session = _EnvVarSession(env_vars)
        prev = getattr(tl, "env_session", None)
        tl.env_session = session
        session.acquire()
        try:
            return fn(*args, **kwargs)
        finally:
            session.release()
            tl.env_session = prev

    def _note_worker_blocked(self):
        """This thread is about to block on objects produced by other
        tasks (reference analog: a worker blocked in ray.get releases its
        lease so the raylet can run other work). Suspends the thread's
        env-var session (any thread) and releases the blocked task's
        acquired resources (pool worker threads). Thread availability is
        handled at dispatch time by _submit_to_workers' overflow
        threads."""
        tl = self._exec_tl
        depth = getattr(tl, "block_depth", 0)
        tl.block_depth = depth + 1
        if depth == 0:
            sess = getattr(tl, "env_session", None)
            if sess is not None and sess.held:
                sess.release()
                tl.env_suspended = True
        if not threading.current_thread().name.startswith("ray_tpu-worker"):
            return
        spec = getattr(tl, "spec", None)
        if (depth == 0 and spec is not None
                and not spec.resources.is_empty()):
            tl.released_resources = True
            self._release_resources(spec.resources)

    def _note_worker_unblocked(self):
        """Re-acquire the task's resources and env session on wake. May
        transiently oversubscribe (available goes negative) — same trade
        the reference makes when a blocked worker resumes; it
        self-corrects when the task finishes and releases."""
        tl = self._exec_tl
        depth = getattr(tl, "block_depth", 1) - 1
        tl.block_depth = depth
        if depth == 0 and getattr(tl, "env_suspended", False):
            tl.env_suspended = False
            sess = getattr(tl, "env_session", None)
            if sess is not None:
                sess.acquire()
        if not threading.current_thread().name.startswith("ray_tpu-worker"):
            return
        spec = getattr(tl, "spec", None)
        if (depth == 0 and getattr(tl, "released_resources", False)
                and spec is not None):
            tl.released_resources = False
            with self._res_cv:
                for k, v in spec.resources.resources.items():
                    self.available_resources[k] = (
                        self.available_resources.get(k, 0.0) - v)

    def wait(self, refs: list[ObjectRef], num_returns=1, timeout=None):
        # Same blocked-worker protocol as get(): a worker parked in
        # wait() must release its resources or children deadlock.
        present = sum(self.store.contains(r.id) for r in refs)
        blocked = present < num_returns
        if blocked:
            self._note_worker_blocked()
        try:
            ready_ids, not_ready_ids = self.store.wait(
                [r.id for r in refs], num_returns, timeout
            )
        finally:
            if blocked:
                self._note_worker_unblocked()
        by_id = {r.id: r for r in refs}
        return [by_id[i] for i in ready_ids], [by_id[i] for i in not_ready_ids]

    def as_future(self, ref: ObjectRef) -> Future:
        """Threadless future: resolved by the store's put notification."""
        fut: Future = Future()
        with self._dep_lock:
            found, value, is_error = self.store.get_entry(ref.id)
            if not found:
                self._future_waiters.setdefault(ref.id, []).append(fut)
                return fut
        if is_error:
            fut.set_exception(value)
        else:
            fut.set_result(value)
        return fut

    # ------------------------------------------------------------------
    # Task submission
    # ------------------------------------------------------------------

    def submit_task(self, spec: TaskSpec) -> list[ObjectRef]:
        # Infeasible demands fail fast (the reference surfaces these to the
        # autoscaler; with a fixed local cluster they can never be satisfied).
        if not spec.resources.fits_in(self.total_resources):
            raise ValueError(
                f"Task {spec.function_name!r} requires "
                f"{spec.resources.resources}, which exceeds cluster capacity "
                f"{self.total_resources}"
            )
        streaming = spec.num_returns in ("streaming", "dynamic")
        if streaming:
            # the end-of-stream count object IS the declared return id:
            # every failure path that seals return_ids lands where the
            # consumer's end check reads (see runtime/streaming.py)
            from ray_tpu_torch.runtime.streaming import (ObjectRefGenerator,
                                                         stream_end_ref)
            spec.return_ids = [stream_end_ref(spec.task_id.binary()).id]
        else:
            spec.return_ids = [ObjectID.from_random()
                               for _ in range(spec.num_returns)]
        if spec.task_type == TaskType.ACTOR_TASK:
            state = self._actors.get(spec.actor_id)
            if state is not None:
                spec.sequence_number = state.submit_seq.next()
        self._resolve_or_queue(spec)
        if streaming:
            return [ObjectRefGenerator(spec.task_id.binary())]
        return [ObjectRef(oid) for oid in spec.return_ids]

    def _task_dependencies(self, spec: TaskSpec) -> set[ObjectID]:
        deps: set[ObjectID] = set()
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef) and not self.store.contains(a.id):
                deps.add(a.id)
        return deps

    def _resolve_or_queue(self, spec: TaskSpec):
        deps = self._task_dependencies(spec)
        if not deps:
            self._mark_ready(spec)
            return
        with self._dep_lock:
            # Re-check under the lock: objects may have landed meanwhile.
            deps = {d for d in deps if not self.store.contains(d)}
            if not deps:
                pass
            else:
                self._unresolved[spec.task_id] = deps
                for d in deps:
                    self._waiting_on.setdefault(d, []).append(spec)
                return
        self._mark_ready(spec)

    def _on_object_available(self, oid: ObjectID):
        newly_ready: list[TaskSpec] = []
        with self._dep_lock:
            for spec in self._waiting_on.pop(oid, []):
                pending = self._unresolved.get(spec.task_id)
                if pending is None:
                    continue
                pending.discard(oid)
                if not pending:
                    del self._unresolved[spec.task_id]
                    newly_ready.append(spec)
            waiters = self._future_waiters.pop(oid, [])
        for spec in newly_ready:
            self._mark_ready(spec)
        if waiters:
            found, value, is_error = self.store.get_entry(oid)
            for fut in waiters:
                if not found:
                    continue
                if is_error:
                    fut.set_exception(value)
                else:
                    fut.set_result(value)
        if oid in self._released_oids:
            # every reference was dropped before the producing task
            # finished: free on arrival (futures above resolved first);
            # discard-then-free mirrors _on_ref_zero so the concurrent
            # paths converge on exactly one (idempotent) free
            self._released_oids.discard(oid)
            self.store.free([oid])

    def _mark_ready(self, spec: TaskSpec):
        if spec.task_type == TaskType.ACTOR_TASK:
            self._dispatch_actor_task(spec)
            return
        with self._ready_cv:
            self._ready.append(spec)
            self._ready_cv.notify()

    # ------------------------------------------------------------------
    # Dispatcher (reference: LocalTaskManager::ScheduleAndDispatchTasks)
    # ------------------------------------------------------------------

    def _dispatch_loop(self):
        """Dispatch ready tasks that fit in available resources; park the rest
        (no head-of-line blocking — a busy big task must not starve small
        ones, and resource waits must not deadlock dependent chains)."""
        while True:
            with self._ready_cv:
                while not self._ready and not self._shutdown:
                    self._ready_cv.wait(timeout=0.5)
                if self._shutdown:
                    return
                spec = self._ready.popleft()
            if self._try_acquire(spec.resources):
                if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                    # Dedicated thread: creation is on the critical path of
                    # every queued method call (callers block on it), so it
                    # must never starve behind long tasks in the pool. The
                    # "ray_tpu-worker" prefix opts it into the
                    # blocked-worker protocol (a blocking __init__ must
                    # release its resources too).
                    threading.Thread(
                        target=self._execute_task, args=(spec,),
                        name="ray_tpu-worker-actor-creation", daemon=True,
                    ).start()
                else:
                    self._submit_to_workers(spec)
            else:
                with self._res_cv:
                    self._blocked.append(spec)

    def _try_acquire(self, rs: ResourceSet) -> bool:
        if rs.is_empty():
            return True
        with self._res_cv:
            if not rs.fits_in(self.available_resources):
                return False
            for k, v in rs.resources.items():
                self.available_resources[k] = self.available_resources.get(k, 0.0) - v
            return True

    def _release_resources(self, rs: ResourceSet):
        if rs.is_empty():
            return
        unparked: list[TaskSpec] = []
        with self._res_cv:
            for k, v in rs.resources.items():
                self.available_resources[k] = self.available_resources.get(k, 0.0) + v
            unparked = list(self._blocked)
            self._blocked.clear()
            self._res_cv.notify_all()
        if unparked:
            with self._ready_cv:
                self._ready.extend(unparked)
                self._ready_cv.notify()

    # ------------------------------------------------------------------
    # Execution (reference: _raylet.pyx execute_task)
    # ------------------------------------------------------------------

    def _materialize_args(self, spec: TaskSpec):
        args = [
            self.store.get([a.id])[0] if isinstance(a, ObjectRef) else a
            for a in spec.args
        ]
        kwargs = {
            k: self.store.get([v.id])[0] if isinstance(v, ObjectRef) else v
            for k, v in spec.kwargs.items()
        }
        return args, kwargs

    def _store_results(self, spec: TaskSpec, result):
        if spec.num_returns in ("streaming", "dynamic"):
            from ray_tpu_torch.runtime.streaming import store_stream

            store_stream(
                result, spec.task_id.binary(),
                lambda oid, v, er: self.store.put(ObjectID(oid), v,
                                                  is_error=er),
                lambda oid, n: self.store.put(ObjectID(oid), n))
            self._task_done(spec)
            return
        try:
            if spec.num_returns == 1:
                self.store.put(spec.return_ids[0], result)
            else:
                values = list(result)  # may raise on non-iterable results
                if len(values) != spec.num_returns:
                    raise ValueError(
                        f"Task declared num_returns={spec.num_returns} but "
                        f"returned {len(values)} values"
                    )
                for oid, v in zip(spec.return_ids, values):
                    self.store.put(oid, v)
        except BaseException as e:  # noqa: BLE001 - must never lose return ids
            self._store_error(spec, exc.TaskError(spec.function_name, e))
            return
        self._task_done(spec)

    def _store_error(self, spec: TaskSpec, error: BaseException):
        for oid in spec.return_ids:
            self.store.put(oid, error, is_error=True)
        self._task_done(spec)

    def _task_done(self, spec: TaskSpec):
        """Completion bookkeeping: drop per-task tracking state so long-running
        drivers don't leak (one entry per task otherwise)."""
        for oid in spec.return_ids:
            self._return_owner.pop(oid, None)
        self._cancelled.discard(spec.task_id)
        if spec.actor_id is not None:
            state = self._actors.get(spec.actor_id)
            if state is not None:
                state.in_flight.pop(spec.task_id, None)

    def _execute_task(self, spec: TaskSpec):
        if spec.task_id in self._cancelled:
            self._release_resources(spec.resources)
            self._store_error(spec, exc.TaskCancelledError(spec.task_id))
            return
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            # Creation holds its resources for the actor's lifetime; release
            # happens in kill_actor / creation-failure, not here.
            self._execute_actor_creation(spec)
            return
        self._exec_tl.spec = spec
        try:
            try:
                args, kwargs = self._materialize_args(spec)
            except BaseException as e:  # dep failed -> propagate as task error
                self._store_error(spec, e)
                return
            try:
                result = self._call_in_runtime_env(
                    spec.runtime_env, spec.function, args, kwargs)
                if _isawaitable(result):
                    result = self._await_on_loop(result)
            except BaseException as e:  # noqa: BLE001
                if spec.max_retries > 0 and spec.retry_exceptions:
                    spec.max_retries -= 1
                    self._resolve_or_queue(spec)
                    return
                self._store_error(spec, exc.TaskError(spec.function_name, e))
                return
            self._store_results(spec, result)
        finally:
            self._exec_tl.spec = None
            self._release_resources(spec.resources)

    # ------------------------------------------------------------------
    # Actors (reference: GcsActorManager + DirectActorTaskSubmitter)
    # ------------------------------------------------------------------

    def _effective_namespace(self, override: str | None = None) -> str:
        return override or self.namespace

    def create_actor(self, spec: TaskSpec, name: str | None = None,
                     namespace: str | None = None,
                     lifetime: str | None = None) -> ActorID:
        # ``lifetime`` is owner-scoped in cluster mode; in local mode the
        # owner IS this process, so every actor dies with it either way.
        actor_id = ActorID.from_random()
        spec.actor_id = actor_id
        ns = self._effective_namespace(namespace)
        state = ActorState(
            actor_id=actor_id,
            name=name,
            namespace=ns,
            max_restarts=spec.max_restarts,
            creation_spec=spec,
        )
        state.executor = ThreadPoolExecutor(
            max_workers=max(1, spec.max_concurrency),
            thread_name_prefix=f"actor-{actor_id.hex()[:8]}",
        )
        with self._actor_lock:
            if name is not None:
                # registry key carries the namespace (same convention as
                # the GCS registry, runtime/gcs.py:_ns_key); state.name
                # stays the bare user-visible name
                key = f"{ns}\x1f{name}"
                if key in self._named_actors:
                    raise ValueError(
                        f"Actor name {name!r} already taken in namespace "
                        f"{ns!r}")
                self._named_actors[key] = actor_id
            self._actors[actor_id] = state
        self._resolve_or_queue(spec)  # creation waits on arg deps like any task
        return actor_id

    def _execute_actor_creation(self, spec: TaskSpec):
        # NOTE: actor resources are held for the actor's LIFETIME (released in
        # kill_actor/shutdown), matching the reference's lease semantics — not
        # released when __init__ returns.
        state = self._actors[spec.actor_id]
        # Opt into the blocked-worker protocol: a __init__ that blocks in
        # get() must release the actor's held resources while it waits.
        self._exec_tl.spec = spec
        try:
            args, kwargs = self._materialize_args(spec)
            cls = spec.function
            instance = self._call_in_runtime_env(
                spec.runtime_env, cls, args, kwargs)
        except BaseException as e:  # noqa: BLE001
            state.dead = True
            state.death_reason = f"__init__ failed: {e!r}"
            self._release_resources(spec.resources)
            self._store_error(
                spec, exc.ActorDiedError(spec.actor_id, state.death_reason)
            )
            self._fail_pending_actor_tasks(state)
            return
        finally:
            self._exec_tl.spec = None
        with state.lock:
            state.instance = instance
        # Creation "return" marks readiness (reference: actor creation task
        # return signals schedulability of queued method calls).
        self._store_results(spec, None)

    def _dispatch_actor_task(self, spec: TaskSpec):
        """Buffer by sequence number; dispatch strictly in submission order
        (reference: SequentialActorSubmitQueue). An early call whose arg deps
        resolve late must still run before later calls on the same actor."""
        state = self._actors.get(spec.actor_id)
        if state is None or state.dead:
            reason = state.death_reason if state else "unknown actor"
            self._store_error(spec, exc.ActorDiedError(spec.actor_id, reason))
            return
        with state.lock:
            state.seq_buffer[spec.sequence_number] = spec
            runnable = []
            while state.next_to_dispatch in state.seq_buffer:
                s = state.seq_buffer.pop(state.next_to_dispatch)
                state.next_to_dispatch += 1
                state.in_flight[s.task_id] = s
                runnable.append(s)
        for s in runnable:
            state.executor.submit(self._execute_actor_task, state, s)

    def _fail_pending_actor_tasks(self, state: ActorState):
        """Store ActorDiedError for every queued/buffered call so get() never
        hangs on a killed actor's in-flight results."""
        with state.lock:
            buffered = list(state.seq_buffer.values())
            state.seq_buffer.clear()
            in_flight = list(state.in_flight.values())
            state.in_flight.clear()
        err_specs = buffered + in_flight
        for s in err_specs:
            # Store.put is first-write-wins: if the task already completed,
            # this is a no-op; otherwise consumers observe the death.
            self._store_error(
                s, exc.ActorDiedError(state.actor_id, state.death_reason)
            )

    def _execute_actor_task(self, state: ActorState, spec: TaskSpec):
        if spec.task_id in self._cancelled:
            self._store_error(spec, exc.TaskCancelledError(spec.task_id))
            return
        if state.dead:
            self._store_error(
                spec, exc.ActorDiedError(state.actor_id, state.death_reason)
            )
            return
        # Wait for __init__ to finish (creation task runs on the main pool).
        while state.instance is None and not state.dead:
            time.sleep(0.001)
        if state.dead:
            self._store_error(
                spec, exc.ActorDiedError(state.actor_id, state.death_reason)
            )
            return
        try:
            args, kwargs = self._materialize_args(spec)
            method = getattr(state.instance, spec.actor_method_name)
            renv = (state.creation_spec.runtime_env
                    if state.creation_spec is not None else None)
            result = self._call_in_runtime_env(renv, method, args, kwargs)
            if _isawaitable(result):
                # ASYNC actor method: schedule the coroutine on the
                # shared event loop and RETURN the pool thread
                # immediately — awaits overlap up to max_concurrency
                # (semaphore), and quick sync methods (metrics, pings)
                # keep running on free pool threads instead of queueing
                # behind slow requests (reference: fibers,
                # core_worker/fiber.h:17)
                self._spawn_actor_coro(state, spec, result)
                return
        except BaseException as e:  # noqa: BLE001
            self._store_error(
                spec, exc.TaskError(f"{spec.function_name}", e)
            )
            return
        self._store_results(spec, result)

    def _ensure_async_loop(self):
        import asyncio

        with self._actor_lock:
            loop = getattr(self, "_async_loop", None)
            if loop is None:
                loop = asyncio.new_event_loop()
                self._async_loop = loop
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="runtime-asyncio-loop").start()
        return loop

    def _await_on_loop(self, awaitable):
        """Run an awaitable to completion on the runtime's shared event
        loop (started lazily), blocking the calling pool thread."""
        import asyncio

        loop = self._ensure_async_loop()

        async def drive():
            return await awaitable

        return asyncio.run_coroutine_threadsafe(drive(), loop).result()

    def _spawn_actor_coro(self, state: ActorState, spec: TaskSpec,
                          awaitable):
        """Fire an async actor call onto the shared loop (non-blocking);
        results/errors are stored from the loop when it finishes."""
        import asyncio

        loop = self._ensure_async_loop()
        if state.async_sem is None:
            # under the lock: two pool threads dispatching concurrently
            # must share ONE semaphore or max_concurrency isn't enforced
            with self._actor_lock:
                if state.async_sem is None:
                    mc = (state.creation_spec.max_concurrency
                          if state.creation_spec is not None else 1)
                    state.async_sem = asyncio.Semaphore(max(1, int(mc or 1)))

        async def drive():
            async with state.async_sem:
                try:
                    result = await awaitable
                except BaseException as e:  # noqa: BLE001
                    self._store_error(
                        spec, exc.TaskError(f"{spec.function_name}", e))
                    return
                self._store_results(spec, result)

        asyncio.run_coroutine_threadsafe(drive(), loop)

    def get_actor(self, name: str, namespace: str | None = None) -> ActorID:
        key = f"{self._effective_namespace(namespace)}\x1f{name}"
        with self._actor_lock:
            if key not in self._named_actors:
                raise ValueError(f"Failed to look up actor with name {name!r}")
            return self._named_actors[key]

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self._actor_lock:
            state = self._actors.get(actor_id)
            if state is None:
                return
            already_dead = state.dead
            state.dead = True
            state.death_reason = "killed via kill()"
            if state.name:
                self._named_actors.pop(
                    f"{state.namespace}\x1f{state.name}", None)
        if already_dead:
            return
        if state.executor:
            state.executor.shutdown(wait=False, cancel_futures=True)
        self._fail_pending_actor_tasks(state)
        if state.creation_spec is not None:
            self._release_resources(state.creation_spec.resources)

    def actor_state(self, actor_id: ActorID) -> ActorState | None:
        return self._actors.get(actor_id)

    # ------------------------------------------------------------------
    # Cancellation
    # ------------------------------------------------------------------

    def cancel(self, ref: ObjectRef, force: bool = False):
        # Best-effort: mark every task whose return id matches. Local mode
        # cannot interrupt a running Python frame (same caveat as the
        # reference for non-async actors); queued tasks fail fast.
        # Find the owning spec lazily: we track via return-id -> task map.
        tid = self._return_owner.get(ref.id)
        if tid is not None:
            self._cancelled.add(tid)

    def note_return_owner(self, spec: TaskSpec):
        for oid in spec.return_ids:
            self._return_owner[oid] = spec.task_id

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def shutdown(self):
        self._shutdown = True
        if self._ref_enabled:
            self._refs.set_local_release(None)
            self._refs.reset()
        with self._ready_cv:
            self._ready_cv.notify_all()
        with self._res_cv:
            self._res_cv.notify_all()
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._actor_lock:
            actors = list(self._actors.values())
            self._actors.clear()
            self._named_actors.clear()
        for state in actors:
            state.dead = True
            state.death_reason = "runtime shutdown"
            if state.executor:
                state.executor.shutdown(wait=False, cancel_futures=True)
            self._fail_pending_actor_tasks(state)

    def cluster_resources(self) -> dict:
        return dict(self.total_resources)

    def available_resources_snapshot(self) -> dict:
        with self._res_lock:
            return dict(self.available_resources)


# ---------------------------------------------------------------------------
# Global runtime management
# ---------------------------------------------------------------------------

_runtime: Runtime | None = None
_runtime_lock = threading.Lock()


def get_runtime() -> Runtime:
    global _runtime
    if _runtime is None:
        raise RuntimeError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() "
            "first."
        )
    return _runtime


def is_initialized() -> bool:
    return _runtime is not None


def init_runtime(config: Config | None = None,
                 resources: dict | None = None,
                 namespace: str | None = None) -> Runtime:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = Runtime(config=config, resources=resources,
                               namespace=namespace)
        return _runtime


def install_runtime(runtime) -> None:
    """Install an externally constructed runtime (cluster mode: the
    ``driver.ClusterRuntime`` duck-types ``Runtime``)."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            raise RuntimeError("a runtime is already initialized")
        _runtime = runtime


def shutdown_runtime():
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None
