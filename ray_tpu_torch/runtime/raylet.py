"""Raylet: per-node manager — scheduler, worker pool, object manager.

Reference analog: ``src/ray/raylet/`` — ``NodeManager`` (node_manager.h:125)
on one event loop hosting the local scheduler (``ClusterTaskManager`` /
``LocalTaskManager``), the worker pool (``worker_pool.cc``), and the object
manager (``src/ray/object_manager/`` — pull/push of objects between nodes).
Like the reference, those are separate components owned by this node
manager — ``runtime/scheduler.py`` (queue/dispatch/leases/resources),
``runtime/worker_pool.py`` (spawn/registration/death/OOM policy),
``runtime/object_manager.py`` (pins/spill/transfer/pulls) — while the
raylet keeps placement routing, actors, cancellation, and the RPC surface.

Port of ``ray_tpu/runtime/raylet.py`` with the fault-injection plane and
the prestart fork server (its policy loop, warm-worker takeover for
actors, and the templates' snapshot in ``node_info``), without the
dashboard agent, the log monitor, the metrics pusher and gauges, and the
profiling and stack RPCs (the observability planes, later slices).
``python -m ray_tpu_torch.runtime.raylet`` runs it as a process.

Differences by design (single-controller Python services):
- workers attach the node's C++ shm store directly (no UDS protocol hop);
- spillback consults the GCS resource view instead of gossiped snapshots
  (the ray_syncer analog is the heartbeat's available-resources report);
- node-to-node object transfer is a pull-only fetch RPC (the reference's
  PushManager handles proactive pushes; pull covers get()/dependency flow).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ray_tpu_torch._private.shm_store import ShmObjectStore
from ray_tpu_torch.runtime import object_codec
from ray_tpu_torch.runtime.gcs import _fits
from ray_tpu_torch.runtime.object_manager import LocalObjectManager
from ray_tpu_torch.runtime.rpc import (
    ReconnectingRpcClient,
    RpcClient,
    RpcServer,
    send_msg,
)
from ray_tpu_torch.runtime.scheduler import TaskScheduler
from ray_tpu_torch.runtime.worker_pool import WorkerHandle, WorkerPool  # noqa: F401
# WorkerHandle is re-exported: it is part of this module's historical API.


class Raylet(RpcServer):
    def __init__(self, *, node_id: str, gcs_address, resources: dict,
                 store_capacity: int = 1 << 30, host: str = "127.0.0.1",
                 labels: dict | None = None,
                 heartbeat_interval_s: float | None = None,
                 infeasible_timeout_s: float = 10.0):
        super().__init__(host, 0)
        self.fault_label = "raylet"   # fault-injection endpoint label
        self.node_id = node_id
        self.gcs_address = tuple(gcs_address)
        from ray_tpu_torch.runtime import fault_injection as _fi
        _fi.maybe_init_from_config(self.gcs_address)
        self.store_name = f"/rtt_{os.getpid()}_{node_id[:8]}"
        self.store = ShmObjectStore(self.store_name, capacity=store_capacity,
                                    create=True)
        self.labels = labels or {}
        # per-worker stdout/stderr files (a dead worker's last words)
        import tempfile

        self.log_dir = tempfile.mkdtemp(
            prefix=f"rtt-logs-{node_id[:8]}-")

        # reconnecting: survives a GCS restart (file-backed recovery)
        self._gcs = ReconnectingRpcClient(self.gcs_address,
                                          label="raylet")
        self._gcs_lock = threading.Lock()   # RpcClient is thread-safe; lock
                                            # keeps call+interpret atomic
        # LIVENESS gets its own connection + lock: on the shared channel
        # a task-flood's pick_node/spillback burst queues hundreds of
        # lock-waiters ahead of the beat, and the GCS falsely declares
        # this node dead mid-flood (seen at the 2k-actor envelope tier).
        self._gcs_beat = ReconnectingRpcClient(self.gcs_address,
                                               label="raylet")
        self._gcs_beat_lock = threading.Lock()
        self._peers: dict[str, RpcClient] = {}
        self._peer_addrs: dict[str, tuple] = {}
        self._peers_lock = threading.Lock()

        self.workers = WorkerPool(
            self, max_workers=max(1, int(resources.get("CPU", 1))))
        # (actor_id, incarnation) placements currently inside spawn() —
        # the host_actor idempotency window (see rpc_host_actor)
        # (actor_id, incarnation) -> in-flight hosting attempt: event +
        # outcome, so a deduped GCS retry can RETURN THE FIRST CALL'S
        # RESULT instead of unconditional success (an unconditional ok
        # for a first call that then failed — with its error reply lost
        # on the dead channel that caused the retry — left actors
        # PENDING forever with no failure report)
        self._pending_hosts: dict[tuple, dict] = {}
        # report_objects idempotency: token -> first reply (bounded)
        from collections import OrderedDict
        self._report_tokens: OrderedDict[str, dict] = OrderedDict()
        self._report_tokens_lock = threading.Lock()
        self.scheduler = TaskScheduler(
            self, resources=resources,
            infeasible_timeout_s=infeasible_timeout_s)
        self._threads: list[threading.Thread] = []
        from ray_tpu_torch.utils.config import get_config
        _cfg = get_config()
        self._hb_interval = (heartbeat_interval_s
                             if heartbeat_interval_s is not None
                             else _cfg.raylet_heartbeat_interval_s)
        self._spillback_queue_depth = _cfg.scheduler_spillback_queue_depth
        # versioned resource sync (reference: ray_syncer.h:86): local
        # resource mutations push to the GCS at RPC latency; heartbeats
        # carry only the version. The view carries queue depth too so
        # placement can prefer shallow queues when everyone is busy.
        from ray_tpu_torch.runtime.resource_sync import ResourceSyncer
        self.resource_syncer = ResourceSyncer(
            self, self._avail_snapshot,
            load_fn=lambda: len(self.scheduler.ready),
            push_delay_s=_cfg.resource_sync_push_delay_s)
        self.scheduler.on_resources_changed = \
            self.resource_syncer.mark_changed
        self.scheduler.on_queue_changed = \
            self.resource_syncer.mark_changed
        self._mem_threshold = _cfg.memory_usage_threshold
        self._mem_refresh_s = max(_cfg.memory_monitor_refresh_ms, 50) / 1e3
        # actor_ready acks coalesce here: worker ready messages buffer
        # and a flusher ships ONE actors_ready batch to the GCS per
        # linger window (was one GCS call per worker message — an actor
        # flood paid a full control-plane RTT per actor)
        self._ready_buf: list[dict] = []
        self._ready_cv = threading.Condition()
        self._ready_linger_s = _cfg.actor_ready_linger_s
        self.objects = LocalObjectManager(
            self, store=self.store, store_capacity=store_capacity, cfg=_cfg)
    # component-facing compatibility views (tests and the
    # worker pool read these under their historical names)
    @property
    def _workers(self):
        return self.workers.workers

    @property
    def spill_stats(self):
        return self.objects.spill_stats

    @property
    def total_resources(self):
        return self.scheduler.total_resources

    @property
    def available(self):
        return self.scheduler.available

    @property
    def infeasible_timeout_s(self):
        return self.scheduler.infeasible_timeout_s

    def _kick_dispatch(self):
        self.scheduler.kick()

    def _release(self, demand: dict):
        self.scheduler.release(demand)

    def _enqueue(self, task: dict):
        self.scheduler.enqueue(task)

    def _avail_snapshot(self) -> dict:
        return self.scheduler.avail_snapshot()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self):
        super().start()
        with self._gcs_lock:
            self._gcs.call(
                "register_node", node_id=self.node_id, address=self.address,
                store_name=self.store_name, resources=self.total_resources,
                labels=self.labels)
        self.resource_syncer.start()
        loops = [self.scheduler.dispatch_loop, self._heartbeat_loop,
                 self.workers.monitor_loop, self.scheduler.infeasible_loop,
                 self.objects.location_flush_loop,
                 self._ready_flush_loop,
                 self.workers.prestart_policy_loop]
        if self.objects.spill_enabled:
            loops.append(self.objects.spill_loop)
        if self._mem_threshold > 0:
            loops.append(lambda: self.workers.memory_monitor_loop(
                self._mem_threshold, self._mem_refresh_s))
        for target in loops:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        super().stop()
        self.objects.stop()
        self.scheduler.stop()
        with self._ready_cv:
            self._ready_cv.notify_all()   # ready flusher exits
        # join background loops BEFORE closing the store: a mid-tick spill
        # loop dereferencing the munmapped segment is a segfault, not an
        # exception
        for t in self._threads:
            t.join(timeout=2.0)
        self.workers.stop()
        # handlers still running (a worker's ensure_local, a fetch) return
        # before the segment goes: one inside the store after close()
        # would touch unmapped memory
        self.wait_idle(5.0)
        import shutil

        shutil.rmtree(self.log_dir, ignore_errors=True)
        try:
            self._gcs_beat.close()
        except OSError:
            pass
        self.store.close()
        self.objects.cleanup_disk()

    def _interruptible_sleep(self, seconds: float):
        """Sleep in small increments so background loops observe
        ``_stopping`` within ~0.1s — stop() joins them with a short
        timeout before munmapping the store, and a loop that oversleeps
        the join touches freed memory (segfault, not an exception)."""
        deadline = time.monotonic() + seconds
        while not self._stopping:
            remain = deadline - time.monotonic()
            if remain <= 0:
                return
            time.sleep(min(0.1, remain))

    # ------------------------------------------------------------------
    # worker pool RPC surface (logic: runtime/worker_pool.py)
    # ------------------------------------------------------------------

    def rpc_register_worker(self, conn, send_lock, *, worker_id,
                            push_addr=None):
        return self.workers.register(conn, send_lock, worker_id=worker_id,
                                     push_addr=push_addr)

    def rpc_runtime_env_failed(self, conn, send_lock, *, key: str,
                               error: str):
        """A worker died setting up its runtime env (e.g. pip install
        failure): fail every queued task with that env NOW and stop
        respawning workers for it for a while — otherwise the queue
        drives an infinite spawn/install/crash loop with the real error
        trapped in worker stderr."""
        from ray_tpu_torch.utils import exceptions as exc

        self.workers.mark_bad_env(key, error)
        doomed = self.scheduler.drop_queued_with_env(key)
        for task in doomed:
            self._store_task_error(task, exc.RuntimeEnvSetupError(
                f"runtime env setup failed: {error}"))
        return {"failed_tasks": len(doomed)}

    def rpc_worker_death_info(self, conn, send_lock, *, worker_id: str,
                              timeout_s: float = 2.0):
        """Why a worker died (lease owners map a broken lease to e.g.
        OutOfMemoryError instead of a generic crash). The owner's lease
        connection breaks the instant the process dies — often BEFORE
        this raylet's channel reader records the death — so this briefly
        waits for the record instead of returning an empty answer."""
        deadline = time.monotonic() + timeout_s
        while True:
            info = self.workers.death_info(worker_id)
            if info is not None:
                return info
            if time.monotonic() >= deadline or self._stopping:
                return {}
            time.sleep(0.05)

    def _retry_or_fail_dead_worker_task(self, w: WorkerHandle, task: dict):
        """Retry/error policy for the in-flight task of a dead worker
        (called by WorkerPool.on_worker_gone)."""
        decided = all(self.store.contains(bytes.fromhex(o))
                      for o in task.get("return_oids", ()))
        if decided or task.get("cancelled"):
            pass   # cancelled (error pre-stored) or results written:
                   # a retry would re-run completed/cancelled work
        elif w.oom_killed:
            # OOM kills have their OWN budget (config task_oom_retries,
            # reference RAY_task_oom_retries): host pressure from an
            # unrelated process must not burn the task's max_retries
            # lineage budget, and re-dispatch backs off so a
            # still-pressured node doesn't churn through the budget in
            # a few monitor ticks.
            from ray_tpu_torch.utils.config import get_config

            total = get_config().task_oom_retries
            left = task.get("_oom_retries_left", total)
            if left > 0:
                task["_oom_retries_left"] = left - 1
                delay = min(8.0, 1.0 * 2 ** (total - left))
                self.scheduler.defer_enqueue(task, delay)
            else:
                from ray_tpu_torch.utils import exceptions as exc
                self._store_task_error(task, exc.OutOfMemoryError(
                    f"task {task.get('name')}: worker killed to relieve "
                    f"host memory pressure (threshold "
                    f"{self._mem_threshold}; {total} OOM retries "
                    f"exhausted)"))
        elif task.get("max_retries", 0) > 0:
            task["max_retries"] -= 1
            self._enqueue(task)
        else:
            from ray_tpu_torch.utils import exceptions as exc
            info = self.workers.death_info(w.worker_id) or {}
            reason = f"worker died executing {task.get('name')}"
            if info.get("crash_point"):
                reason += f" at crash point {info['crash_point']}"
            if info.get("last_words"):
                reason += ("; last words: "
                           + " | ".join(info["last_words"][-2:]))
            self._store_task_error(task, exc.WorkerCrashedError(reason))

    def _store_task_error(self, task: dict, error: BaseException):
        from ray_tpu_torch.utils import exceptions as exc
        err = (error if isinstance(error, exc.RayTpuError)
               else exc.WorkerCrashedError(str(error)))
        om = self.objects
        for oid_hex in task.get("return_oids", ()):
            oid = bytes.fromhex(oid_hex)
            if not self.store.contains(oid):
                try:
                    # hold through seal→pin: the error object must not be
                    # evictable before the pin (same protocol as worker
                    # returns)
                    size = object_codec.put_value_durable(
                        self.store, oid, err, is_error=True, hold=True,
                        timeout_s=5.0,
                        request_space=(om.spill_bytes
                                       if om.spill_enabled else None))
                except Exception:  # noqa: BLE001 - already created etc.
                    continue
                om.pin_object(oid_hex)
                om.track_local(oid_hex)
                if size > 0:
                    self.store.release(oid)
                with self._gcs_lock:
                    self._gcs.call("add_object_location", oid=oid_hex,
                                   node_id=self.node_id, size=size)

    # ------------------------------------------------------------------
    # placement routing (reference: ClusterTaskManager spillback policy;
    # queueing/dispatch live in runtime/scheduler.py)
    # ------------------------------------------------------------------

    def rpc_submit_task(self, conn, send_lock, *, task: dict,
                        spill_count: int = 0):
        demand = task.get("resources", {})
        strategy = task.get("strategy", {})
        if strategy.get("kind") == "NODE_AFFINITY":
            target = strategy.get("node_id")
            if target and target != self.node_id:
                if self._forward(task, target, spill_count):
                    return {"ok": True, "node_id": target}
        if strategy.get("pg_id") and spill_count == 0:
            # placement-group tasks run on the bundle's reserved node
            with self._gcs_lock:
                target = self._gcs.call("pick_node", demand=demand,
                                        pg_id=strategy["pg_id"])
            if target is not None and target != self.node_id:
                if self._forward(task, target, spill_count + 1):
                    return {"ok": True, "node_id": target}
        if not _fits(demand, self.total_resources) or (
                strategy.get("kind") == "SPREAD" and spill_count == 0):
            # infeasible here (or spread): ask GCS for a placement
            with self._gcs_lock:
                target = self._gcs.call(
                    "pick_node", demand=demand,
                    exclude=[] if _fits(demand, self.total_resources)
                    else [self.node_id],
                    pg_id=strategy.get("pg_id"))
            if target is not None and target != self.node_id:
                if self._forward(task, target, spill_count):
                    return {"ok": True, "node_id": target}
            if not _fits(demand, self.total_resources):
                if (strategy.get("pg_id")
                        or strategy.get("kind") == "NODE_AFFINITY"):
                    # strategy-constrained tasks cannot be re-placed by
                    # the plain-demand retry loop (it would escape the PG
                    # reservation / ping-pong on affinity) — keep the
                    # immediate infeasible error for them
                    self._store_task_error(task, ValueError(
                        f"task {task.get('name')} demands {demand}: "
                        f"infeasible for its placement constraint"))
                    return {"ok": False, "reason": "infeasible"}
                # Cluster-wide infeasible: PARK the task and advertise the
                # unmet demand so the autoscaler can provision for it
                # (reference: infeasible queue feeding
                # GcsAutoscalerStateManager). Errors only after the grace
                # window — a fixed cluster still fails fast enough.
                self.scheduler.park_infeasible(task, demand)
                return {"ok": True, "parked": "infeasible"}
        elif spill_count < 2 and (
                not _fits(demand, self._avail_snapshot())
                or len(self.scheduler.ready)
                > self._spillback_queue_depth):
            # busy OR deeply queued here: one spillback attempt through
            # the GCS view. The QUEUE-DEPTH clause matters at flood
            # scale: per-task acquire/release keeps `available` looking
            # healthy on average, so without it a 200k-task burst piles
            # onto one node's queue while the rest of the cluster idles
            # (reference: hybrid policy scores utilization, and deep
            # local queues spill — cluster_task_manager.cc).
            with self._gcs_lock:
                target = self._gcs.call("pick_node", demand=demand,
                                        exclude=[self.node_id],
                                        pg_id=strategy.get("pg_id"))
            if target is not None and target != self.node_id:
                if self._forward(task, target, spill_count + 1):
                    return {"ok": True, "node_id": target}
        self._enqueue(task)
        return {"ok": True, "node_id": self.node_id}

    def _forward(self, task: dict, node_id: str, spill_count: int) -> bool:
        peer = self._peer(node_id)
        if peer is None:
            return False
        try:
            peer.call("submit_task", task=task, spill_count=spill_count + 1)
            return True
        except Exception:  # noqa: BLE001 - peer died; fall back local
            return False

    def _peer(self, node_id: str) -> RpcClient | None:
        with self._peers_lock:
            client = self._peers.get(node_id)
            if client is not None and client._closed:
                # connection died (peer restarted/stopped): re-resolve
                self._peers.pop(node_id, None)
                self._peer_addrs.pop(node_id, None)
                client = None
        if client is not None:
            return client
        with self._gcs_lock:
            nodes = self._gcs.call("get_nodes", alive_only=True)
        for n in nodes:
            if n["node_id"] == node_id:
                try:
                    client = RpcClient(n["address"], label="raylet")
                except OSError:
                    return None
                with self._peers_lock:
                    self._peers[node_id] = client
                    self._peer_addrs[node_id] = tuple(n["address"])
                return client
        return None

    def _peer_address(self, node_id) -> tuple | None:
        if node_id is None or node_id == self.node_id:
            return None
        if self._peer(node_id) is None:
            return None
        with self._peers_lock:
            return self._peer_addrs.get(node_id)

    # ------------------------------------------------------------------
    # actors (GCS calls host_actor; raylet dedicates a worker)
    # ------------------------------------------------------------------

    def rpc_host_actor(self, conn, send_lock, *, actor_id, spec,
                       incarnation=0):
        """Dedicate a fresh worker to the actor and hand it the creation
        task (reference: GcsActorScheduler::LeaseWorkerFromNode + the
        worker-lease machinery in node_manager.cc:1778).

        IDEMPOTENT per (actor_id, incarnation): the GCS retries a
        placement once when the shared placement channel dies mid-call
        (it cannot know whether the first call landed), so a duplicate
        for an actor already spawning/live here must be a no-op success
        — hosting twice would run two copies of the actor. A duplicate
        arriving while the first call is STILL INSIDE spawn() waits for
        and returns the first call's actual outcome — its synchronous
        failure (try_acquire rejection) must not be masked by an
        unconditional ok when the first reply died with its channel."""
        key = (actor_id, incarnation)
        with self.workers.lock:
            entry = self._pending_hosts.get(key)
            if entry is None:
                for w in self.workers.workers.values():
                    if (w.state == "actor" and w.actor_id == actor_id
                            and w.incarnation == incarnation):
                        return {"ok": True, "dedup": True}
                entry = {"ev": threading.Event(), "result": None,
                         "error": None}
                self._pending_hosts[key] = entry
                owner = True
            else:
                owner = False
        if not owner:
            entry["ev"].wait(timeout=60.0)
            if entry["error"] is not None:
                raise entry["error"]
            if entry["result"] is not None:
                return {**entry["result"], "dedup": True}
            # first call still inside spawn after 60s: treat as in
            # progress (a dead spawn is caught by its own deliver path)
            return {"ok": True, "dedup": True}
        try:
            result = self._host_actor(actor_id, spec, incarnation)
            entry["result"] = result
            return result
        except BaseException as e:
            entry["error"] = e
            raise
        finally:
            entry["ev"].set()
            with self.workers.lock:
                self._pending_hosts.pop(key, None)

    def _host_actor(self, actor_id, spec, incarnation):
        demand = spec.get("resources", {})
        if not self.scheduler.try_acquire(demand):
            raise RuntimeError(
                f"node {self.node_id} cannot host actor: {demand} unavailable")
        # prestart fast path: dedicate a warm already-registered idle
        # worker (its conn is live, so _deliver sends create_actor
        # immediately — no interpreter boot on the actor-creation path);
        # otherwise spawn, which itself prefers a zygote fork
        handle = self.workers.take_idle_for_actor(spec.get("runtime_env"))
        if handle is None:
            handle = self.workers.spawn(spec.get("runtime_env"))
            handle.state = "actor"
        handle.actor_id = actor_id
        handle.incarnation = incarnation
        handle.acquired = dict(demand)

        def _deliver():
            # pip envs legitimately take minutes on a cold cache: give
            # the worker's registration the install window. The plain
            # window is generous too (flag): under an actor-flood spawn
            # storm a fresh interpreter can take >30s just to get
            # scheduled, and a worker that actually DIED is caught by
            # poll() below, not by this deadline.
            from ray_tpu_torch.utils.config import get_config
            renv = (spec.get("runtime_env") or {})
            window = get_config().worker_register_timeout_s
            if renv.get("pip"):
                # an install never SHRINKS the window a plain env gets
                window = max(900.0, window)
            deadline = time.monotonic() + window
            while time.monotonic() < deadline and not self._stopping:
                if handle.conn is not None:
                    try:
                        send_msg(handle.conn,
                                 {"type": "create_actor", "actor_id": actor_id,
                                  "task": spec,
                                  "incarnation": incarnation},
                                 handle.send_lock)
                    except OSError:
                        self.workers.on_worker_gone(handle)
                    return
                if handle.proc is not None and handle.proc.poll() is not None:
                    reason = ("actor worker died during startup "
                              f"(exit code {handle.proc.returncode})")
                    break
                time.sleep(0.01)
            else:
                reason = ("actor worker failed to register within the "
                          "deadline")
            with self._gcs_lock:
                self._gcs.call("actor_failed", actor_id=actor_id,
                               reason=reason)
        threading.Thread(target=_deliver, daemon=True).start()
        return {"ok": True}

    def rpc_host_actors(self, conn, send_lock, *, actors: list):
        """Batched placement frame from the GCS executor: host each
        actor through the idempotent single-actor path, replying
        per-actor outcomes so one infeasible entry cannot fail its
        batch-mates (the GCS feeds failures to the restart/death path
        individually)."""
        results = []
        for ent in actors:
            try:
                res = self.rpc_host_actor(
                    None, None, actor_id=ent["actor_id"],
                    spec=ent["spec"],
                    incarnation=ent.get("incarnation", 0))
                results.append(res)
            except Exception as e:  # noqa: BLE001 - per-actor outcome
                results.append({"ok": False, "error": repr(e)})
        return {"results": results}

    def queue_actor_ready(self, actor_id: str, push_addr):
        """Buffer one worker's actor_ready for the batched GCS ack."""
        with self._ready_cv:
            self._ready_buf.append({"actor_id": actor_id,
                                    "push_addr": push_addr})
            self._ready_cv.notify_all()

    def _ready_flush_loop(self):
        while not self._stopping:
            with self._ready_cv:
                while not self._ready_buf and not self._stopping:
                    self._ready_cv.wait(0.5)
                if self._stopping:
                    return
            if self._ready_linger_s > 0:
                time.sleep(self._ready_linger_s)   # coalesce the burst
            with self._ready_cv:
                batch, self._ready_buf = self._ready_buf, []
            if not batch:
                continue
            try:
                with self._gcs_lock:
                    self._gcs.call("actors_ready", node_id=self.node_id,
                                   actors=batch)
            except Exception:  # noqa: BLE001 - requeue; reconnecting
                # client already burned its redial window, so an ack
                # lost here would strand the actors PENDING forever
                with self._ready_cv:
                    self._ready_buf = batch + self._ready_buf
                self._interruptible_sleep(0.2)

    def rpc_submit_actor_task(self, conn, send_lock, *, task: dict):
        actor_id = task["actor_id"]
        with self.workers.lock:
            target = None
            for w in self.workers.workers.values():
                if w.actor_id == actor_id and w.state == "actor":
                    target = w
                    break
        if target is None or target.conn is None:
            raise LookupError(f"actor {actor_id} not hosted here")
        if task.get("incarnation", 0) != target.incarnation:
            # caller's seq numbering belongs to a previous incarnation —
            # reject so it refreshes (reference: client resend protocol)
            raise LookupError(
                f"actor {actor_id} incarnation mismatch "
                f"(task {task.get('incarnation')} != {target.incarnation})")
        send_msg(target.conn, {"type": "actor_task", "task": task},
                 target.send_lock)
        return {"ok": True}

    def rpc_submit_actor_tasks(self, conn, send_lock, *, tasks: list):
        """Batched actor submission for actors served via this raylet
        (no direct push port): validates and forwards each task over the
        worker channel; one reply per frame."""
        for task in tasks:
            self.rpc_submit_actor_task(conn, send_lock, task=task)
        return {"ok": True}

    def rpc_kill_actor_worker(self, conn, send_lock, *, actor_id):
        with self.workers.lock:
            target = None
            for w in self.workers.workers.values():
                if w.actor_id == actor_id:
                    target = w
                    break
        if target is not None and target.proc is not None:
            target.proc.terminate()
        return {"ok": True}

    # ------------------------------------------------------------------
    # cancellation + explicit free
    # ------------------------------------------------------------------

    def rpc_free_objects(self, conn, send_lock, *, oids: list,
                         broadcast: bool = True):
        """Explicitly release object copies on this node (reference:
        ``ray.internal.free``): unpin, drop from shm and the spill dir,
        deregister the location. Owners drop lineage separately so a
        subsequent ``get`` raises ObjectLostError instead of
        resurrecting the object."""
        freed = self.objects.free_objects(oids)
        if broadcast:
            with self._gcs_lock:
                nodes = self._gcs.call("get_nodes", alive_only=True)
            for n in nodes:
                if n["node_id"] == self.node_id:
                    continue
                peer = self._peer(n["node_id"])
                if peer is None:
                    continue
                try:
                    peer.call("free_objects", oids=list(oids),
                              broadcast=False)
                except Exception:  # noqa: BLE001 - peer gone
                    continue
        return {"freed": freed}

    def rpc_cancel_task(self, conn, send_lock, *, oids: list,
                        force: bool = False, broadcast: bool = True):
        """Cancel the task owning these return oids (reference:
        ``CoreWorker::CancelTask`` → raylet CancelTask RPC): queued tasks
        are dequeued; a running task's worker gets SIGINT (``force``:
        SIGKILL). The TaskCancelledError return object is written FIRST —
        first-write-wins makes a racing normal completion a no-op.
        Already-finished tasks (return objects exist) are untouched."""
        from ray_tpu_torch.utils import exceptions as exc

        targets = set(oids)
        if all(self.store.contains(bytes.fromhex(o)) for o in targets):
            return {"found": True, "state": "finished"}

        def matches(task):
            return task and targets & set(task.get("return_oids", ()))

        # queued here? Dequeued under the scheduler cv; the error store (a
        # durable put + GCS RPC) runs OUTSIDE the cv so dispatch/enqueue
        # never stall behind it. The cancelled flag also covers a task
        # already popped by the dispatch loop but not yet assigned.
        queued = self.scheduler.take_queued_matching(matches)
        if queued is not None:
            queued["cancelled"] = True
            self._store_task_error(queued, exc.TaskCancelledError(
                f"task {queued.get('name')} cancelled while queued"))
            return {"found": True, "state": "queued"}
        # running here?
        with self.workers.lock:
            victim = None
            task = None
            for w in self.workers.workers.values():
                if w.state == "busy" and matches(w.current_task):
                    victim = w
                    task = w.current_task   # captured under the lock
                    task["cancelled"] = True
                    break
        if victim is not None:
            # pre-store the cancelled error; the worker's own
            # (interrupted or successful) write loses the race. Known
            # best-effort window for MULTI-return tasks: if the worker is
            # concurrently writing its returns, the task can complete with
            # a mix of real values and TaskCancelledError across the
            # return set (each oid resolves first-write-wins
            # independently). Cancel is best-effort by contract — callers
            # must treat any TaskCancelledError among the returns as "the
            # task may have partially run".
            self._store_task_error(task, exc.TaskCancelledError(
                f"task {task.get('name')} cancelled while running"))
            with self.workers.lock:
                # re-verify AND signal under the lock: the worker may
                # have finished the target and been handed new work —
                # never deliver the kill/interrupt over someone else's
                # task (finish_task and dispatch both mutate
                # current_task under this lock)
                if victim.current_task is not task:
                    return {"found": True, "state": "running"}
                if force:
                    # no retry for a cancelled task: detach it first
                    victim.current_task = None
                    if victim.proc is not None:
                        try:
                            victim.proc.kill()
                        except OSError:
                            pass
                elif victim.proc is not None:
                    import signal

                    try:
                        victim.proc.send_signal(signal.SIGINT)
                    except OSError:
                        pass
            return {"found": True, "state": "running"}
        # parked infeasible here? (popped under the scheduler lock; the
        # durable error store runs outside it — park_infeasible on the
        # submit path contends for that lock)
        parked = self.scheduler.take_infeasible_matching(matches)
        if parked is not None:
            parked["cancelled"] = True
            self._store_task_error(parked, exc.TaskCancelledError(
                f"task {parked.get('name')} cancelled while infeasible"))
            return {"found": True, "state": "infeasible"}
        if broadcast:
            with self._gcs_lock:
                nodes = self._gcs.call("get_nodes", alive_only=True)
            for n in nodes:
                if n["node_id"] == self.node_id:
                    continue
                peer = self._peer(n["node_id"])
                if peer is None:
                    continue
                try:
                    reply = peer.call("cancel_task", oids=list(oids),
                                      force=force, broadcast=False)
                    if reply.get("found"):
                        return reply
                except Exception:  # noqa: BLE001 - peer gone
                    continue
        return {"found": False}

    # ------------------------------------------------------------------
    # object manager RPC surface (logic: runtime/object_manager.py)
    # ------------------------------------------------------------------

    def rpc_report_object(self, conn, send_lock, *, oid: str, size: int = 0):
        if not self.objects.report_object(oid, size):
            return {"ok": False, "reason": "object not present to pin"}
        return {"ok": True}

    def rpc_report_objects(self, conn, send_lock, *, entries: list,
                           token: str | None = None):
        """Batched report_object (workers buffer their task-return
        reports and flush together; each object is protected by its
        writer's seal-hold until the pin lands here).

        ``token`` makes the batch idempotent: the reporter holds one
        token across redials of the same batch, and a duplicate delivery
        (reply lost to a partition, or an injected duplicate) replays the
        first reply instead of re-running the pins."""
        if token is not None:
            with self._report_tokens_lock:
                cached = self._report_tokens.get(token)
            if cached is not None:
                return cached
        ok = []
        for oid, size in entries:
            if self.objects.report_object(oid, size):
                ok.append(oid)
        reply = {"ok": ok}
        if token is not None:
            with self._report_tokens_lock:
                self._report_tokens[token] = reply
                while len(self._report_tokens) > 4096:
                    self._report_tokens.popitem(last=False)
        return reply

    def rpc_request_space(self, conn, send_lock, *, nbytes: int = 0):
        return {"spilled": self.objects.request_space(nbytes)}

    def rpc_fetch_object(self, conn, send_lock, *, oid: str):
        return self.objects.fetch_object(oid)

    def rpc_fetch_object_meta(self, conn, send_lock, *, oid: str):
        return self.objects.fetch_object_meta(oid)

    def rpc_fetch_object_chunk(self, conn, send_lock, *, oid: str,
                               offset: int, length: int):
        return self.objects.fetch_object_chunk(oid, offset, length)

    def rpc_ensure_local(self, conn, send_lock, *, oids: list,
                         timeout_s: float = 30.0):
        return self.objects.ensure_local(oids, timeout_s)

    # ------------------------------------------------------------------
    # cross-language object plane (reference: the C++/Java clients'
    # msgpack serialization — values cross here as plain data; the RPC
    # layer decodes/encodes the msgpack frames, runtime/xlang.py)
    # ------------------------------------------------------------------

    def rpc_xlang_put(self, conn, send_lock, *, value):
        """Store a plain-data value from an external-language client;
        returns the new object id (hex). The object is a normal store
        object (Python tasks read it natively)."""
        from ray_tpu_torch.utils.ids import ObjectID

        oid = ObjectID.from_random()
        size = object_codec.put_value_durable(
            self.store, oid.binary(), value, hold=True,
            request_space=(self.objects.spill_bytes
                           if self.objects.spill_enabled else None))
        self.objects.pin_object(oid.hex())
        self.objects.track_local(oid.hex())
        if size > 0:
            self.store.release(oid.binary())
        self.objects.queue_location(oid.hex(), size)
        return {"oid": oid.hex()}

    def rpc_xlang_get(self, conn, send_lock, *, oid: str,
                      timeout_s: float = 30.0):
        """Resolve an object to a plain-data value for an external-
        language client: waits/pulls via ensure_local, decodes the stored
        object, and ships it back on the msgpack reply (values outside
        the cross-language domain fail the call, not the server)."""
        missing = self.objects.ensure_local([oid], timeout_s)
        if missing:
            raise TimeoutError(f"object {oid[:8]} not available within "
                               f"{timeout_s}s")
        value, is_error = object_codec.get_value(
            self.store, bytes.fromhex(oid), timeout_ms=0)
        if is_error:
            raise value
        return {"value": value}

    # ------------------------------------------------------------------
    # worker lease RPC surface (logic: runtime/scheduler.py)
    # ------------------------------------------------------------------

    def rpc_request_lease(self, conn, send_lock, *, demand: dict,
                          runtime_env: dict | None = None,
                          timeout_s: float = 10.0, spill_count: int = 0,
                          token: str | None = None):
        return self.scheduler.request_lease(demand, runtime_env, timeout_s,
                                            spill_count, token=token)

    def rpc_cancel_leased(self, conn, send_lock, *, worker_id: str,
                          task: dict, force: bool = False):
        """Cancel a task running on a LEASED worker. The owner (who alone
        knows what its lease is executing) names the worker and supplies
        the task's return oids; this raylet pre-stores the cancel error
        and interrupts (SIGINT) or kills the worker process."""
        from ray_tpu_torch.utils import exceptions as exc

        with self.workers.lock:
            w = self.workers.workers.get(worker_id)
            if w is None or w.state != "leased" or w.proc is None:
                return {"found": False}
        task["cancelled"] = True
        self._store_task_error(task, exc.TaskCancelledError(
            f"task {task.get('name')} cancelled while running"))
        with self.workers.lock:
            w = self.workers.workers.get(worker_id)
            if w is None or w.state != "leased" or w.proc is None:
                return {"found": False}
            try:
                if force:
                    w.proc.kill()
                elif w.conn is not None:
                    # targeted: the worker interrupts the task BY ID
                    # (a raw SIGINT could hit a batchmate in a grouped
                    # push)
                    send_msg(w.conn, {"type": "cancel_push",
                                      "task_id": task.get("task_id", "")},
                             w.send_lock)
            except OSError:
                pass
        return {"found": True}

    def rpc_lease_closed(self, conn, send_lock, *, worker_id: str):
        """The worker's owner-facing connection dropped (lease returned or
        owner died): the worker and its resources go back to the pool."""
        with self.workers.lock:
            w = self.workers.workers.get(worker_id)
            if w is None or w.state != "leased":
                return {"ok": False}
            acquired, w.acquired = w.acquired, {}
            w.idle_since = time.monotonic()
            w.state = "idle"
        self._release(acquired)
        self._kick_dispatch()
        return {"ok": True}

    def rpc_prestart_warm(self, conn, send_lock, *, runtime_env=None,
                          timeout_s: float = 60.0):
        """Spawn (or keep) the fork-server template of ``runtime_env``'s
        key and wait until it is ready to fork: ``PrestartManager.warm``
        for a caller in another process (a driver attached to a node that
        the CLI started). Returns the template's pid and readiness."""
        t = self.workers.prestart.warm(runtime_env)
        if t is None:
            return {"ok": False, "pid": None, "ready": False}
        deadline = time.monotonic() + timeout_s
        while not t.poll_ready(timeout=0.1):
            if not t.alive() or time.monotonic() > deadline:
                break
        return {"ok": t.ready, "pid": t.proc.pid if t.proc else None,
                "ready": t.ready}

    def rpc_prestart_status(self, conn, send_lock):
        """Each ready template's own report (pid, preloaded modules,
        whether torch is imported, CUDA initialized or libcuda mapped,
        its threads), keyed by env key ("default" for the empty env)."""
        with self.workers.prestart.lock:
            templates = dict(self.workers.prestart.templates)
        out = {}
        for key, t in templates.items():
            if t.ready and t.alive():
                try:
                    out[key or "default"] = t.status()
                except (OSError, EOFError):
                    out[key or "default"] = {"ok": False}
        return out

    def rpc_node_info(self, conn, send_lock):
        return {"node_id": self.node_id, "store_name": self.store_name,
                "address": self.address, "resources": self.total_resources,
                "available": self._avail_snapshot(),
                "num_workers": len(self.workers.workers),
                "spill_stats": dict(self.objects.spill_stats),
                "prestart": self.workers.prestart.snapshot()}

    # ------------------------------------------------------------------
    # heartbeat
    # ------------------------------------------------------------------

    def _heartbeat_loop(self):
        ticks = 0
        freed_acks: set[str] = set()
        while not self._stopping:
            self._interruptible_sleep(self._hb_interval)
            if self._stopping:
                return
            ticks += 1
            if ticks % 2 == 0:
                try:
                    self.objects.reconcile_locations()
                except Exception:  # noqa: BLE001 - next tick retries
                    pass
            try:
                acks = sorted(freed_acks) if freed_acks else None
                with self._gcs_beat_lock:
                    # liveness only, on the DEDICATED beat channel: the
                    # versioned syncer carries the resource view at RPC
                    # latency; the beat's payload is O(1) (the version)
                    # unless the GCS asks for a resync
                    reply = self._gcs_beat.call(
                        "heartbeat", node_id=self.node_id,
                        resource_version=self.resource_syncer
                        .pushed_version,
                        freed_acks=acks)
                if acks:
                    freed_acks.difference_update(acks)
                if reply.get("reregister"):
                    with self._gcs_beat_lock:
                        self._gcs_beat.call(
                            "register_node", node_id=self.node_id,
                            address=self.address, store_name=self.store_name,
                            resources=self.total_resources,
                            labels=self.labels)
                    self.resource_syncer.force_push()
                elif reply.get("need_resources"):
                    # version mismatch (lost push / GCS restart): resync
                    self.resource_syncer.force_push()
                # refcount releases ride the heartbeat reply (at-least-
                # once: acked on the NEXT beat; freeing is idempotent)
                release = reply.get("release_oids")
                if release:
                    try:
                        self.objects.free_objects(release,
                                                  deregister=False)
                    finally:
                        freed_acks.update(release)
            except Exception:  # noqa: BLE001 - gcs down; keep trying
                pass


def main():  # runs a raylet as a standalone process (cluster_utils spawns it)
    import json
    import signal

    from ray_tpu_torch.runtime import fault_injection as _fi
    # role stamp BEFORE construction: crash rules scoped proc="raylet"
    # may only ever kill external raylet processes like this one
    _fi.set_process_label("raylet")
    cfg = json.loads(sys.argv[1])
    raylet = Raylet(
        node_id=cfg["node_id"],
        gcs_address=tuple(cfg["gcs_address"]),
        resources=cfg["resources"],
        store_capacity=cfg.get("store_capacity", 1 << 30),
        labels=cfg.get("labels"),
        infeasible_timeout_s=cfg.get("infeasible_timeout_s", 10.0),
    )
    stop_ev = threading.Event()
    # graceful shutdown must run on SIGTERM too (Cluster.remove_node uses
    # terminate()); otherwise the shm segment leaks in /dev/shm
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    signal.signal(signal.SIGINT, lambda *_: stop_ev.set())
    raylet.start()
    # signal readiness to the parent via stdout
    print(json.dumps({"address": raylet.address,
                      "store_name": raylet.store_name}), flush=True)
    try:
        stop_ev.wait()
    finally:
        raylet.stop()


if __name__ == "__main__":
    main()
