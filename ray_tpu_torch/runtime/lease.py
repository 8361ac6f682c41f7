"""Owner-side worker-lease protocol.

Port of ``ray_tpu/runtime/lease.py`` without the owner-side stage timers
of the metrics plane (a later slice). Reference:
``CoreWorkerDirectTaskSubmitter`` (``direct_task_transport.cc:134``
``RequestNewWorkerIfNeeded``, ``:191`` ``OnWorkerIdle``, ``:234``
``PushNormalTask``). The owner leases a worker slot from a raylet, then
pushes tasks DIRECTLY to the leased worker over a dedicated connection:

- the raylet schedules once per LEASE, not once per task — while the
  owner's queue for a resource shape is non-empty, tasks flow over the
  held connection with no scheduler hop (the reference's lease-reuse
  throughput win);
- the connection is the liveness channel: when the worker (or its node)
  dies, the owner's in-flight push fails SYNCHRONOUSLY and the task is
  retried or failed on the spot — replacing the round-1 time-based
  "presumed lost after a grace" heuristic that could double-submit slow
  but healthy tasks.

Placement-constrained tasks (placement groups, node affinity, spread)
keep the raylet-queue path — their placement is per-task by nature —
as do lease-infeasible fallbacks; the raylet's queue also keeps serving
its own internal retries.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from ray_tpu_torch.runtime.rpc import ConnectionLost, RpcClient

class Lease:
    """One granted worker lease = one dedicated connection to the worker's
    push port. Closing the connection returns the lease (the worker tells
    its raylet, which frees the slot)."""

    __slots__ = ("client", "worker_id", "node_id", "addr", "raylet_addr")

    def __init__(self, addr, worker_id: str, node_id: str, raylet_addr):
        self.addr = tuple(addr)
        self.client = RpcClient(self.addr, label="owner")
        self.worker_id = worker_id
        self.node_id = node_id
        self.raylet_addr = tuple(raylet_addr)  # the granting raylet
        # First request on the wire tags this connection as THE lease
        # channel on the worker side (its push port is shared with
        # observability and direct-actor clients, whose disconnects must
        # not release the lease). Fire-and-forget: the server handles a
        # connection's requests in order, so the tag lands before any
        # push; the reader thread consumes the reply.
        try:
            self.client.call_async("lease_attach")
        except BaseException:
            # attach failed (worker died mid-dial): close the dialed
            # socket + its reader thread before the caller's handback
            # path discards this half-constructed lease
            self.client.close()
            raise

    def close(self):
        self.client.close()


def _shape_key(task: dict) -> tuple:
    from ray_tpu_torch.runtime_env import env_key

    res = tuple(sorted(task.get("resources", {}).items()))
    return (res, env_key(task.get("runtime_env")))


def _leasable(task: dict) -> bool:
    kind = task.get("strategy", {}).get("kind")
    pg = task.get("strategy", {}).get("pg_id")
    return not pg and kind in (None, "", "DEFAULT")


class LeaseManager:
    """Per-owner submission engine: one queue per resource shape, one
    pusher thread per held lease, legacy raylet-queue fallback."""

    def __init__(self, raylet_client: RpcClient, *,
                 legacy_submit: Callable[[dict], None],
                 on_task_failed: Callable[[dict, BaseException], None],
                 on_direct_results: Callable[[dict], None] | None = None,
                 max_leases_per_shape: int | None = None,
                 lease_block_s: float | None = None):
        from ray_tpu_torch.utils.config import get_config

        cfg = get_config()
        self._raylet = raylet_client
        self._legacy_submit = legacy_submit
        self._on_task_failed = on_task_failed
        # small task returns riding the push reply (owner-store path)
        self._on_direct_results = on_direct_results
        self._max_per_shape = (max_leases_per_shape
                               if max_leases_per_shape is not None
                               else cfg.max_leases_per_shape)
        self._lease_block_s = (lease_block_s if lease_block_s is not None
                               else cfg.lease_block_s)
        # flags lease_group_size / lease_pipeline_depth (class attrs
        # keep the measured defaults as documentation)
        self.GROUP_SIZE = cfg.lease_group_size
        self.PIPELINE_DEPTH = cfg.lease_pipeline_depth
        self._lock = threading.Lock()
        self._queues: dict[tuple, deque] = {}
        self._pushers: dict[tuple, int] = {}
        # pushers currently HOLDING a lease (vs acquiring/parked): sizes
        # fair-share grouping and gates spawn growth to actual capacity
        self._holding: dict[tuple, int] = {}
        self._in_flight: dict[str, tuple] = {}   # task_id -> (task, lease)
        self._stopping = False

    # ------------------------------------------------------------------

    def submit(self, task: dict):
        """Non-blocking: enqueue and make sure enough pushers are draining
        this shape's queue (one pusher == at most one lease == one task in
        flight, so pusher count scales concurrency up to the cap)."""
        if self._stopping or not _leasable(task):
            self._legacy_submit(task)
            return
        key = _shape_key(task)
        spawn = 0
        with self._lock:
            q = self._queues.setdefault(key, deque())
            q.append(task)
            active = self._pushers.get(key, 0)
            holding = self._holding.get(key, 0)
            # Spawn at most ONE prober, and only when every active pusher
            # already holds a lease: pool growth is GRANT-driven (a pusher
            # that acquires with surplus queue spawns the next prober in
            # _pusher), so the pool ramps one grant at a time up to the
            # cluster's real capacity instead of stampeding max_per_shape
            # threads at 4 lease slots — 60 parked probers per shape turn
            # the raylet's lease queue into the bottleneck. A drip-fed
            # shape still grows: each submit seeing all-holders-busy adds
            # exactly one prober.
            spawn = 1 if (active < self._max_per_shape
                          and active - holding <= 0) else 0
            if spawn:
                self._pushers[key] = active + 1
        for _ in range(max(spawn, 0)):
            threading.Thread(target=self._pusher, args=(key,),
                             name="ray_tpu-lease-pusher", daemon=True).start()

    def stop(self):
        """Stop pushers: no new work, wake blocked pushes by severing the
        lease connections, and never touch runtime state (store/raylet)
        again — shutdown munmaps the store under us otherwise."""
        self._stopping = True
        with self._lock:
            leases = [lease for _, lease in self._in_flight.values()
                      if lease is not None]
            self._queues.clear()
        for lease in leases:
            try:
                lease.close()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------------

    def _pop(self, key: tuple):
        with self._lock:
            q = self._queues.get(key)
            if q:
                return q.popleft()
            return None

    PIPELINE_DEPTH = 2   # in-flight push GROUPS per lease (hides owner RTT)
    # max tasks packed into one push RPC: 64 measured ~20% faster than
    # 32 at 4 leases (fewer reply wakeups contending for the owner GIL);
    # deeper pipelining (4) measured WORSE — more pusher-thread churn
    GROUP_SIZE = 64

    def _pop_group(self, key: tuple, limit: int) -> list:
        with self._lock:
            q = self._queues.get(key)
            if not q:
                return []
            # fair-share grouping: one pusher must not swallow the whole
            # queue while sibling LEASES sit idle — divide by pushers that
            # actually HOLD a worker (probers parked at a saturated raylet
            # would otherwise shrink groups to 1 and turn every task into
            # its own round trip)
            share = max(1, len(q) // max(1, self._holding.get(key, 1)))
            take = min(limit, share)
            out = []
            while q and len(out) < take:
                out.append(q.popleft())
            return out

    def _note_acquired(self, key: tuple):
        """A pusher acquired a lease: count it as a holder, and — grant-
        driven growth — spawn the NEXT prober while queued work outruns
        the pool, so the pool ramps to cluster capacity one grant at a
        time with at most one prober parked at a saturated raylet."""
        spawn = False
        with self._lock:
            self._holding[key] = self._holding.get(key, 0) + 1
            q = self._queues.get(key)
            if q and self._pushers.get(key, 0) < self._max_per_shape:
                self._pushers[key] = self._pushers.get(key, 0) + 1
                spawn = True
        if spawn:
            threading.Thread(target=self._pusher, args=(key,),
                             name="ray_tpu-lease-pusher", daemon=True).start()

    def _note_released(self, key: tuple):
        with self._lock:
            left = self._holding.get(key, 0) - 1
            if left > 0:
                self._holding[key] = left
            else:
                self._holding.pop(key, None)

    def _pusher(self, key: tuple):
        lease: Lease | None = None
        window: deque = deque()   # (tasks, PendingCall) in push order

        def _drop_in_flight(tasks):
            with self._lock:
                for t in tasks:
                    self._in_flight.pop(t.get("task_id", ""), None)

        def _break_all(error, info=None):
            # the lease died: every group in the window is lost together —
            # ONE death-info query covers them all
            nonlocal lease
            broken, lease = lease, None
            self._note_released(key)
            if info is None:
                info = self._death_info(broken)
            try:
                broken.close()
            except Exception:  # noqa: BLE001
                pass
            while window:
                tasks, _ = window.popleft()
                _drop_in_flight(tasks)
                for t in tasks:
                    self._handle_break(t, error, info)

        def _send_group(tasks) -> bool:
            with self._lock:
                for t in tasks:
                    self._in_flight[t.get("task_id", "")] = (t, lease)
            try:
                if len(tasks) == 1:
                    pending = lease.client.call_async("push_task",
                                                      task=tasks[0])
                else:
                    pending = lease.client.call_async("push_tasks",
                                                      tasks=tasks)
            except (ConnectionLost, OSError) as e:
                window.append((tasks, None))
                _break_all(e)
                return False
            window.append((tasks, pending))
            return True

        try:
            while not self._stopping:
                # fill the window: send up to PIPELINE_DEPTH task GROUPS
                # (GROUP_SIZE tasks per RPC) before waiting on the oldest
                # reply — groups amortize the framing/pickle overhead,
                # pipelining hides the owner's round trip (the worker
                # executes its connection's requests in order)
                while lease is not None and len(window) < self.PIPELINE_DEPTH:
                    tasks = self._pop_group(key, self.GROUP_SIZE)
                    tasks = [t for t in tasks if not t.get("cancelled")]
                    if not tasks:
                        break
                    if not _send_group(tasks):
                        break
                if window:
                    tasks, pending = window.popleft()
                    try:
                        if pending is None:
                            raise ConnectionLost("lease lost before send")
                        reply = pending.result(timeout=None)
                        results = (reply or {}).get("results")
                        if results and self._on_direct_results:
                            # small returns came back IN the reply:
                            # land them in the owner's store before the
                            # tasks are considered complete
                            self._on_direct_results(results)
                        # lineage marker: these objects EXISTED (the node
                        # may still die before the batched location flush
                        # — recovery then resubmits with no lease channel
                        # left to watch)
                        for t in tasks:
                            t["_completed"] = True
                        _drop_in_flight(tasks)
                    except (ConnectionLost, OSError, TimeoutError,
                            EOFError) as e:
                        _drop_in_flight(tasks)
                        info = self._death_info(lease) if lease else {}
                        for t in tasks:
                            self._handle_break(t, e, info)
                        if lease is not None:
                            _break_all(e, info)
                    continue
                # window empty: need a lease and/or more work
                task = self._pop(key)
                if task is None:
                    return
                tid = task.get("task_id", "")
                # visible to cancel() from pop to completion — with
                # lease=None while still acquiring ("queued" semantics)
                with self._lock:
                    self._in_flight[tid] = (task, None)
                if lease is None:
                    lease = self._acquire_lease(task)
                    if lease is not None:
                        self._note_acquired(key)
                if lease is None:
                    # unplaceable via lease (infeasible / exhausted
                    # retries): the raylet queue owns parking, autoscaler
                    # demand reporting and the infeasible error path
                    _drop_in_flight([task])
                    if not self._stopping and not task.get("cancelled"):
                        try:
                            self._legacy_submit(task)
                        except Exception:  # noqa: BLE001
                            pass  # raylet gone; owner is shutting down
                    continue
                if task.get("cancelled"):
                    _drop_in_flight([task])
                    continue
                _send_group([task])
        finally:
            if lease is not None:
                lease.close()
                self._note_released(key)
            with self._lock:
                left = self._pushers.get(key, 1) - 1
                if left <= 0:
                    self._pushers.pop(key, None)
                else:
                    self._pushers[key] = left

    def _acquire_lease(self, task: dict) -> Lease | None:
        """Request a lease from the local raylet, following spillback
        redirects; parks (server-side, event-driven) while the cluster is
        saturated.

        Every connection here is this pusher's OWN: the RPC server
        handles a connection's requests serially, so a parked lease
        request on the shared driver↔raylet client would stall every
        other driver RPC (gets, reports, cancels) behind it.
        """
        home: RpcClient | None = None
        transient: RpcClient | None = None
        # One idempotency token per logical acquisition, held across
        # transport retries: a grant whose reply was lost (reset,
        # healed partition) is returned AGAIN by the raylet instead of
        # leasing a second worker — without it every lost reply leaked a
        # granted worker until the never-dialed watchdog reclaimed it.
        import uuid as _uuid
        token = _uuid.uuid4().hex
        transport_failures = 0
        try:
            try:
                home = RpcClient(self._raylet.address, label="driver")
            except OSError:
                return None
            target = home
            hops = 0
            retries = 0
            while not self._stopping:
                try:
                    resp = target.call(
                        "request_lease",
                        demand=task.get("resources", {}),
                        runtime_env=task.get("runtime_env"),
                        timeout_s=self._lease_block_s,
                        spill_count=hops,
                        token=token,
                        timeout=self._lease_block_s + 5.0)
                except (ConnectionLost, OSError, TimeoutError, EOFError):
                    transport_failures += 1
                    if self._stopping or transport_failures > 2:
                        return None  # raylet unreachable: legacy fallback
                    # the request may have been APPLIED with the reply
                    # lost: redial and retry with the SAME token so an
                    # already-granted worker is reused, not duplicated
                    time.sleep(0.2)
                    if transient is not None:
                        transient.close()
                        transient = None
                    home.close()
                    try:
                        home = RpcClient(self._raylet.address,
                                         label="driver")
                    except OSError:
                        return None
                    target = home
                    hops = 0
                    continue
                if resp.get("ok"):
                    try:
                        return Lease(resp["worker_addr"], resp["worker_id"],
                                     resp["node_id"], target.address)
                    except (OSError, ConnectionLost):
                        # ConnectionLost (not an OSError): the attach
                        # call_async can raise it when the worker died
                        # between grant and dial-completion — same
                        # handback as a failed dial
                        # dial failed (worker died, or owner-side fd
                        # pressure): hand the grant BACK — an undailed
                        # lease would leak the worker + its resources
                        try:
                            target.call("lease_closed",
                                        worker_id=resp["worker_id"],
                                        timeout=5)
                        except Exception:  # noqa: BLE001
                            pass
                        return None
                if resp.get("redirect") and hops < 4:
                    hops += 1
                    if transient is not None:
                        transient.close()
                        transient = None
                    try:
                        transient = RpcClient(tuple(resp["redirect"]),
                                              label="driver")
                    except OSError:
                        return None
                    target = transient
                    continue
                if resp.get("retry"):
                    # parked past the server-side window: KEEP WAITING —
                    # a feasible-but-busy cluster eventually grants, and
                    # falling back to the raylet-queue path here pushed
                    # entire floods through the non-direct-return channel
                    # (200k-task drains then crawled through cross-node
                    # pulls of tiny results). The generous cap only
                    # breaks true wedges; the task then takes the legacy
                    # path's recovery machinery.
                    retries += 1
                    if retries % 3 == 0 and target is not home:
                        # go home: the local raylet parks in ITS queue
                        if transient is not None:
                            transient.close()
                            transient = None
                        target = home
                        hops = 0
                    if retries >= 240:
                        return None
                    continue
                return None  # infeasible or unknown reply
            return None
        finally:
            if transient is not None:
                transient.close()
            if home is not None:
                home.close()

    def _death_info(self, lease: Lease) -> dict:
        client = None
        try:
            client = RpcClient(lease.raylet_addr, timeout=5,
                               label="driver")
            info = client.call("worker_death_info",
                               worker_id=lease.worker_id) or {}
            info.setdefault("node_id", lease.node_id)
            info.setdefault("worker_id", lease.worker_id)
            return info
        except Exception:  # noqa: BLE001 - node died with the worker
            return {"node_unreachable": True, "node_id": lease.node_id,
                    "worker_id": lease.worker_id}
        finally:
            if client is not None:
                client.close()

    def _handle_break(self, task: dict, error: BaseException,
                      death_info: dict):
        if self._stopping:
            return  # owner shutting down; the store may be unmapped
        if task.get("cancelled"):
            return  # force-cancel killed the worker; error pre-stored
        if task.get("_completed"):
            return  # its push already completed (window break after it)
        if death_info.get("oom_killed"):
            # memory-pressure kill: separate budget + backoff (the node is
            # likely still pressured), never burning max_retries
            from ray_tpu_torch.utils import exceptions as exc
            from ray_tpu_torch.utils.config import get_config

            total = get_config().task_oom_retries
            left = task.get("_oom_retries_left", total)
            if left > 0:
                task["_oom_retries_left"] = left - 1
                time.sleep(min(8.0, 1.0 * 2 ** (total - left)))
                self.submit(task)
            else:
                self._on_task_failed(task, exc.OutOfMemoryError(
                    f"task {task.get('name')}: worker killed to relieve "
                    f"host memory pressure ({total} OOM retries "
                    f"exhausted)"))
            return
        if task.get("max_retries", 0) > 0:
            task["max_retries"] -= 1
            self.submit(task)
        else:
            self._on_task_failed(
                task, _typed_death_error(task, error, death_info))

    # ------------------------------------------------------------------

    def cancel(self, oids: set, force: bool = False):
        """Cancel a lease-managed task by return oid. Returns
        ('queued', task) — removed before it was pushed, caller seals the
        cancel error — or ('running', task) — the executing node's raylet
        was told to interrupt/kill the leased worker — or None."""
        with self._lock:
            for q in self._queues.values():
                for i, t in enumerate(q):
                    if oids & set(t.get("return_oids", ())):
                        t["cancelled"] = True
                        del q[i]
                        return ("queued", t)
            hit = None
            for task, lease in self._in_flight.values():
                if oids & set(task.get("return_oids", ())):
                    hit = (task, lease)
                    break
        if hit is None:
            return None
        task, lease = hit
        task["cancelled"] = True
        if lease is None:
            # its pusher is still acquiring a lease; the flag makes it
            # skip the push — caller seals the cancel error
            return ("queued", task)
        client = None
        try:
            client = RpcClient(lease.raylet_addr, timeout=10,
                               label="driver")
            client.call("cancel_leased", worker_id=lease.worker_id,
                        task=task, force=force)
        except (ConnectionLost, OSError, TimeoutError):
            pass  # node dying anyway; the lease break seals the outcome
        finally:
            if client is not None:
                client.close()
        return ("running", task)


def _typed_death_error(task: dict, error: BaseException,
                       death_info: dict) -> BaseException:
    """Death-boundary error taxonomy: a crashed peer surfaces as
    NodeDiedError / WorkerCrashedError (carrying node/worker identity
    and the worker's last words when there are some, and the injected
    crash point when there is one), never a bare transport
    ConnectionLost/TimeoutError whose redial deadline happens to be the
    thing that fired."""
    from ray_tpu_torch.utils import exceptions as exc

    if isinstance(error, exc.RayTpuError):
        return error
    name = task.get("name", "?")
    if death_info.get("node_unreachable"):
        return exc.NodeDiedError(
            death_info.get("node_id"),
            f"raylet unreachable while task {name!r} was leased there "
            f"({error!r})")
    reason = f"worker died while running task {name!r}"
    if death_info.get("crash_point"):
        reason += f" at crash point {death_info['crash_point']}"
    if death_info.get("last_words"):
        last = " | ".join(death_info["last_words"][-2:])
        reason += f"; last words: {last}"
    return exc.WorkerCrashedError(f"{reason} ({error!r})")
