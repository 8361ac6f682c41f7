"""Per-node task scheduler: the ready queue, the dispatch loop, worker
lease granting, resource accounting, and infeasible-task parking.

Port of ``ray_tpu/runtime/scheduler.py``, with its crash point
``raylet.before_lease_grant``. Reference analog: ``src/ray/raylet/scheduling/cluster_task_manager.cc``
(queue + spillback + infeasible parking) and ``local_task_manager.cc``
(dispatch to workers), plus the lease queue behind
``NodeManager::HandleRequestWorkerLease`` (node_manager.cc:1778). A
component OWNED by the raylet (``runtime/raylet.py``): placement routing
(``rpc_submit_task``) stays on the raylet — it is the RPC surface and
peer-forwarding concern — and calls ``enqueue`` here once a task is
placed on this node.

One condition variable (``cv``) guards the ready queue, the parked lease
waiters, and the dispatch generation counter; the dispatch loop serves
both queued tasks and lease grants so workers/resources are handed out
by a single arbiter (no lease-vs-task race for the last slot).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ray_tpu_torch.runtime import fault_injection as _fi
from ray_tpu_torch.runtime.gcs import _fits
from ray_tpu_torch.runtime.rpc import send_msg


class TaskScheduler:
    """Scheduling + resource accounting for one raylet node. ``node`` is
    the owning Raylet (worker pool, GCS client, peer table, error
    paths)."""

    def __init__(self, node, *, resources: dict, infeasible_timeout_s: float):
        self._node = node
        self.total_resources = dict(resources)
        self.available = dict(resources)
        self._res_lock = threading.Lock()
        self.ready: deque[dict] = deque()
        self.cv = threading.Condition()
        # bumped on every completion/registration: the dispatch loop
        # re-checks it under the cv so a kick racing the wait is never lost
        self._dispatch_gen = 0
        # parked worker-lease requests (guarded by cv)
        self.lease_waiters: deque[dict] = deque()
        # cluster-wide infeasible tasks awaiting capacity (autoscaler)
        self.infeasible_timeout_s = infeasible_timeout_s
        self._infeasible: list = []
        self._infeasible_lock = threading.Lock()
        # OOM-backoff timers (cancelled by stop())
        self._deferred_timers: set[threading.Timer] = set()
        self._timers_lock = threading.Lock()
        # idempotency: token -> granted reply, so a retried request_lease
        # (owner redialled after a partition ate the reply) re-reads the
        # grant it already holds instead of burning a second worker
        self._grant_tokens: OrderedDict[str, dict] = OrderedDict()
        self._grant_lock = threading.Lock()
        # set by the raylet: notified on every acquire/release so the
        # versioned resource syncer pushes the new view at RPC latency
        # (reference: ray_syncer RESOURCE_VIEW — runtime/resource_sync.py)
        self.on_resources_changed = lambda: None
        # queue-depth changes feed the same versioned view (placement
        # prefers shallow queues)
        self.on_queue_changed = lambda: None

    def stop(self):
        """Cancel deferred timers and fail parked lease waiters (owners
        fall back instead of blocking out their timeout on a dying
        node). Runs before background threads are joined."""
        with self._timers_lock:
            timers = list(self._deferred_timers)
            self._deferred_timers.clear()
        for timer in timers:
            timer.cancel()
        with self.cv:
            waiters = list(self.lease_waiters)
            self.lease_waiters.clear()
        for waiter in waiters:
            waiter["result"] = {"retry": True}
            waiter["event"].set()

    # ------------------------------------------------------------------
    # queue + kicks
    # ------------------------------------------------------------------

    def enqueue(self, task: dict):
        with self.cv:
            self.ready.append(task)
            self.cv.notify()
        self.on_queue_changed()

    def defer_enqueue(self, task: dict, delay: float):
        """Re-enqueue after a delay (OOM backoff). Timers are tracked so
        stop() cancels them — an untracked timer firing after the store
        closes would enqueue into a dead dispatch loop; the task is then
        lost like any other task queued on a stopping node (cluster-level
        recovery owns that case)."""
        timer = threading.Timer(delay, self._timer_enqueue, args=(task,))
        timer.daemon = True
        with self._timers_lock:
            if self._node._stopping:
                return
            self._deferred_timers.add(timer)
        timer.start()

    def _timer_enqueue(self, task: dict):
        with self._timers_lock:
            self._deferred_timers = {t for t in self._deferred_timers
                                     if t.is_alive()}
        if not self._node._stopping:
            self.enqueue(task)

    def kick(self):
        with self.cv:
            self._dispatch_gen += 1
            self.cv.notify()

    def take_queued_matching(self, matches) -> dict | None:
        """Dequeue (under the cv) the first ready task satisfying
        ``matches`` — the cancel path; the caller stores the error
        OUTSIDE the cv so dispatch/enqueue never stall behind it."""
        with self.cv:
            for i, t in enumerate(self.ready):
                if matches(t):
                    task = t
                    del self.ready[i]
                    self.on_queue_changed()
                    return task
        return None

    def drop_queued_with_env(self, key: str) -> list:
        """Dequeue every ready task whose runtime-env key matches (the
        failed-env fail-fast path); returns the dropped tasks."""
        from ray_tpu_torch.runtime_env import env_key as _env_key

        doomed = []
        with self.cv:
            keep = deque()
            while self.ready:
                task = self.ready.popleft()
                if _env_key(task.get("runtime_env")) == key:
                    doomed.append(task)
                else:
                    keep.append(task)
            self.ready = keep
        if doomed:
            self.on_queue_changed()
        return doomed

    # ------------------------------------------------------------------
    # resource accounting
    # ------------------------------------------------------------------

    def avail_snapshot(self) -> dict:
        with self._res_lock:
            return dict(self.available)

    def try_acquire(self, demand: dict) -> bool:
        with self._res_lock:
            if not _fits(demand, self.available):
                return False
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) - v
        if demand:
            self.on_resources_changed()
        return True

    def release(self, demand: dict):
        if not demand:
            return
        with self._res_lock:
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v
        self.on_resources_changed()
        # freed capacity may unblock a parked lease request or queued task
        self.kick()

    # ------------------------------------------------------------------
    # dispatch loop (reference: LocalTaskManager::DispatchScheduledTasks)
    # ------------------------------------------------------------------

    def dispatch_loop(self):
        node = self._node
        pool = node.workers
        while not node._stopping:
            with self.cv:
                while (not self.ready and not self.lease_waiters
                       and not node._stopping):
                    self.cv.wait(timeout=0.2)
                if node._stopping:
                    return
                gen0 = self._dispatch_gen
                task = None
                # first task whose resources fit (avoid head-of-line block)
                for i, t in enumerate(self.ready):
                    if _fits(t.get("resources", {}), self.avail_snapshot()):
                        task = t
                        del self.ready[i]
                        break
            if task is not None:
                # dequeues must reach the synced view too, or the GCS
                # `load` only ever rises and placement shuns this node
                self.on_queue_changed()
            self._serve_lease_waiters()
            if task is None:
                # only lease waiters, or no fitting task: block until the
                # next kick (completion/registration/release)
                with self.cv:
                    if self._dispatch_gen == gen0 and not node._stopping:
                        self.cv.wait(timeout=0.1)
                continue
            env_err = pool.bad_env_error(task.get("runtime_env"))
            if env_err is not None:
                from ray_tpu_torch.utils import exceptions as exc
                node._store_task_error(task, exc.RuntimeEnvSetupError(
                    f"runtime env setup failed: {env_err}"))
                continue
            gen = self._dispatch_gen
            worker = pool.idle_worker(task.get("runtime_env"))
            if worker is None:
                self.enqueue(task)
                # wait for a completion/registration kick instead of a
                # fixed sleep: task_done latency, not a poll, sets the
                # dispatch rate when all workers are busy. The generation
                # check under the cv closes the missed-wakeup race (a
                # kick between the snapshot above and this wait).
                with self.cv:
                    if self._dispatch_gen == gen and not node._stopping:
                        self.cv.wait(timeout=0.2)
                continue
            if not self.try_acquire(task.get("resources", {})):
                worker.state = "idle"
                self.enqueue(task)
                continue
            cancelled = False
            with pool.lock:
                # under the lock: cancel_task scans current_task here, and
                # a cancel that ran between the queue pop and this point
                # left a flag on the task dict
                if task.get("cancelled"):
                    cancelled = True
                    worker.state = "idle"
                else:
                    worker.acquired = dict(task.get("resources", {}))
                    worker.current_task = task
                    worker.dispatched_at = time.monotonic()
            if cancelled:
                # outside the workers lock: release kicks the dispatch cv,
                # and holding the worker lock across that inverts the
                # cv→workers lock order used by the lease grant path
                self.release(task.get("resources", {}))
                continue
            try:
                send_msg(worker.conn, {"type": "task", "task": task},
                         worker.send_lock)
            except OSError:
                pool.on_worker_gone(worker)
                self.enqueue(task)

    # ------------------------------------------------------------------
    # worker leases (owner-side lease protocol; reference:
    # NodeManager::HandleRequestWorkerLease node_manager.cc:1778 +
    # CoreWorkerDirectTaskSubmitter direct_task_transport.cc:134,240)
    # ------------------------------------------------------------------

    def request_lease(self, demand: dict, runtime_env: dict | None,
                      timeout_s: float, spill_count: int,
                      token: str | None = None) -> dict:
        """Grant a worker lease: the reply carries the worker's push
        address, and the owner pushes tasks to it directly for as long as
        it holds the lease (= keeps its connection to the worker open).
        Replies: {ok, worker_addr, worker_id, node_id} | {redirect: addr}
        (spillback — caller retries there) | {retry: True} (parked past
        timeout_s — caller may re-request) | {infeasible: True}.

        ``token`` makes the grant idempotent: a retry carrying the same
        token (the owner's transport died after the grant but before the
        reply landed) gets the SAME grant back as long as that worker is
        still leased, instead of a second worker."""
        node = self._node
        if token is not None:
            cached = self._token_grant(token)
            if cached is not None:
                return cached
        if not _fits(demand, self.total_resources):
            with node._gcs_lock:
                target = node._gcs.call("pick_node", demand=demand,
                                        exclude=[node.node_id])
            addr = node._peer_address(target)
            if addr:
                return {"redirect": list(addr), "node_id": target}
            return {"infeasible": True}
        if spill_count < 1 and not _fits(demand, self.avail_snapshot()):
            # busy here: one spillback attempt through the GCS view
            # (mirror of rpc_submit_task's policy)
            with node._gcs_lock:
                target = node._gcs.call("pick_node", demand=demand,
                                        exclude=[node.node_id])
            addr = node._peer_address(target)
            if addr:
                return {"redirect": list(addr), "node_id": target}
        waiter = {"demand": demand, "runtime_env": runtime_env,
                  "event": threading.Event(), "result": None}
        with self.cv:
            self.lease_waiters.append(waiter)
            self.cv.notify()
        if not waiter["event"].wait(timeout=timeout_s):
            removed = True
            with self.cv:
                try:
                    self.lease_waiters.remove(waiter)
                except ValueError:
                    removed = False
            if not removed:
                # a granter claimed the waiter concurrently: it WILL set
                # the result (it already holds the worker + resources) —
                # block for it; dropping it would leak a leased worker
                # nobody ever dials
                waiter["event"].wait(timeout=5.0)
                if waiter["result"]:
                    self._cache_grant(token, waiter["result"])
                    return waiter["result"]
            return {"retry": True}
        self._cache_grant(token, waiter["result"])
        return waiter["result"]

    def _cache_grant(self, token: str | None, result: dict | None):
        if token is None or not (result and result.get("ok")):
            return
        with self._grant_lock:
            self._grant_tokens[token] = result
            while len(self._grant_tokens) > 1024:
                self._grant_tokens.popitem(last=False)

    def _token_grant(self, token: str) -> dict | None:
        """Replay a cached grant — but only while its worker is still in
        state ``leased`` (the owner may have dialed + finished + returned
        the lease between the retries; replaying then would hand out a
        stale address for a worker someone else now holds)."""
        with self._grant_lock:
            cached = self._grant_tokens.get(token)
        if cached is None:
            return None
        worker = self._node.workers.workers.get(cached.get("worker_id"))
        if worker is not None and worker.state == "leased":
            return cached
        with self._grant_lock:
            self._grant_tokens.pop(token, None)
        return None

    def _serve_lease_waiters(self):
        """Grant parked lease requests FIFO while workers + resources are
        available (runs on the dispatch thread)."""
        node = self._node
        pool = node.workers
        while True:
            with self.cv:
                if not self.lease_waiters:
                    return
                waiter = self.lease_waiters[0]
            env_err = pool.bad_env_error(waiter["runtime_env"])
            if env_err is not None:
                with self.cv:
                    try:
                        self.lease_waiters.remove(waiter)
                    except ValueError:
                        continue
                waiter["result"] = {"infeasible": True,
                                    "env_error": env_err}
                waiter["event"].set()
                continue
            worker = pool.idle_worker(waiter["runtime_env"])
            if worker is None:
                return  # spawn in progress / pool exhausted; kick revisits
            if worker.push_addr is None:
                # externally-registered worker with no push port (tests):
                # unusable for leases, put it back
                with pool.lock:
                    worker.state = "idle"
                return
            if not self.try_acquire(waiter["demand"]):
                with pool.lock:
                    worker.state = "idle"
                return  # resources busy; release kick revisits
            # the waiter may have timed out and removed itself while we
            # were acquiring — then the grant must be rolled back. The
            # rollback runs OUTSIDE the cv (lock order: never cv→locks).
            claimed = True
            with self.cv:
                try:
                    self.lease_waiters.remove(waiter)
                except ValueError:
                    claimed = False
            if not claimed:
                self.release(waiter["demand"])
                with pool.lock:
                    worker.state = "idle"
                continue
            # crash point: waiter claimed, resources acquired, grant not
            # yet sent — the owner's retry must land on a respawned node
            # or spill elsewhere (chaos soak raylet class)
            _fi.maybe_crash("raylet.before_lease_grant")
            with pool.lock:
                worker.state = "leased"
                worker.acquired = dict(waiter["demand"])
                worker.dispatched_at = time.monotonic()
            # arm the worker's never-dialed watchdog BEFORE the owner can
            # learn the address (guarantees msg-before-dial ordering)
            try:
                send_msg(worker.conn, {"type": "lease_granted"},
                         worker.send_lock)
            except OSError:
                pass
            waiter["result"] = {"ok": True,
                                "worker_addr": list(worker.push_addr),
                                "worker_id": worker.worker_id,
                                "node_id": node.node_id}
            waiter["event"].set()

    # ------------------------------------------------------------------
    # infeasible-task parking (reference: ClusterTaskManager infeasible
    # queue + GcsAutoscalerStateManager demand reporting)
    # ------------------------------------------------------------------

    def park_infeasible(self, task: dict, demand: dict):
        deadline = time.monotonic() + self.infeasible_timeout_s
        node = self._node
        with self._infeasible_lock:
            self._infeasible.append((task, demand, deadline))
            all_demands = [d for _, d, _ in self._infeasible]
        try:
            with node._gcs_lock:
                # full parked set: a per-task report would overwrite
                # siblings' demands in the GCS view
                node._gcs.call("report_demand", node_id=node.node_id,
                               demands=all_demands)
        except Exception:  # noqa: BLE001 - advertising only
            pass

    def take_infeasible_matching(self, matches) -> dict | None:
        """Pop (under the lock) the first parked infeasible task matching
        — the cancel path; error storing runs outside the lock."""
        with self._infeasible_lock:
            for i, (t, _, _) in enumerate(self._infeasible):
                if matches(t):
                    return self._infeasible.pop(i)[0]
        return None

    def infeasible_loop(self):
        """Retry parked tasks as capacity appears (a new node registers);
        error them when the grace window expires."""
        node = self._node
        while not node._stopping:
            time.sleep(0.25)
            with self._infeasible_lock:
                parked, self._infeasible = self._infeasible, []
            if not parked:
                continue
            still: list = []
            now = time.monotonic()
            demands_left = []
            for task, demand, deadline in parked:
                # this node's capacity is fixed; recovery means a NEW
                # node registered and the GCS can now place the task
                placed = False
                try:
                    with node._gcs_lock:
                        target = node._gcs.call(
                            "pick_node", demand=demand,
                            exclude=[node.node_id])
                    if target is not None and node._forward(
                            task, target, 0):
                        placed = True
                except Exception:  # noqa: BLE001
                    pass
                if placed:
                    continue
                if now > deadline:
                    node._store_task_error(task, ValueError(
                        f"task {task.get('name')} demands {demand}: "
                        f"infeasible (no node satisfied it within "
                        f"{self.infeasible_timeout_s}s)"))
                else:
                    still.append((task, demand, deadline))
                    demands_left.append(demand)
            with self._infeasible_lock:
                self._infeasible.extend(still)
            try:
                with node._gcs_lock:
                    node._gcs.call("report_demand", node_id=node.node_id,
                                   demands=demands_left)
            except Exception:  # noqa: BLE001
                pass
