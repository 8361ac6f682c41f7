"""Driver/worker-side cluster runtime: the core_worker analog.

Reference analog: ``src/ray/core_worker/core_worker.cc`` (SubmitTask:1878,
CreateActor:1948, SubmitActorTask:2182, Put:1141, Get:1353, Wait:1509) as
driven from ``python/ray/_private/worker.py``. Duck-types the same interface
as the in-process ``runtime.core.Runtime`` so ``ray_tpu_torch.api`` works
unchanged in both modes.

The driver attaches its local node's shm store directly (same-host zero-copy
path), submits tasks to the local raylet (which schedules locally or spills
back through the GCS view), and resolves remote objects through the
raylet's pull-based object manager.

Port of ``ray_tpu/runtime/driver.py``. Functions, classes and arguments
travel as the port's stdlib-pickle blobs (``runtime/serialization.py``); a
body pickle cannot carry raises ``TypeError`` at submission. Left for
later slices: the worker-log echo, the metrics pusher, the memory plane's
ownership annex and the trace spans and stuck-call watchdog (the
observability planes).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from ray_tpu_torch._private.shm_store import ShmObjectStore
from ray_tpu_torch.runtime import object_codec
from ray_tpu_torch.runtime import refcount as _refcount
from ray_tpu_torch.runtime import serialization
from ray_tpu_torch.runtime.object_ref import ObjectRef
from ray_tpu_torch.runtime.rpc import (
    ConnectionLost,
    ReconnectingRpcClient,
    RpcClient,
)
from ray_tpu_torch.runtime.task_spec import TaskSpec, TaskType
from ray_tpu_torch.utils import exceptions as exc
from ray_tpu_torch.utils.ids import ActorID, ObjectID, WorkerID


_SCALAR_TYPES = (type(None), bool, int, float, str, bytes)


class ClusterRuntime:
    """Connects ``ray_tpu_torch.api`` to a running cluster (GCS + raylets)."""

    def __init__(self, gcs_address, raylet_address=None,
                 namespace: str | None = None):
        self.gcs_address = tuple(gcs_address)
        # arm the fault-injection plane (no-op unless the config flag is
        # set) BEFORE any channel dials: a startup plan must see every
        # connection this runtime makes
        from ray_tpu_torch.runtime import fault_injection as _fi
        _fi.maybe_init_from_config(self.gcs_address,
                                   process_label="driver")
        # reconnecting: survives a GCS restart (file-backed recovery)
        self._gcs = ReconnectingRpcClient(self.gcs_address, label="driver")
        self.caller_id = WorkerID.from_random().hex()
        # ref-counting client identity: inside a pool worker the PROCESS
        # id (the Worker's flusher owns the channel there — one client
        # per process so holder attribution is consistent); drivers use
        # their own caller id (reference: reference_count.h — per-worker
        # ownership)
        import os as _os
        self.client_id = _os.environ.get("RAY_TPU_TORCH_WORKER_ID",
                                         self.caller_id)
        # Namespace for named actors (reference: worker.py:1157,1258):
        # explicit init(namespace=...), else the job's own id — two jobs
        # on one cluster never collide on actor names by default. Worker-
        # side implicit runtimes resolve the AMBIENT task namespace first
        # (runtime_context), so a job's tasks see their job's actors.
        self.namespace = namespace or f"job-{self.caller_id[:12]}"
        # choose local raylet: given address, or the head node from GCS
        if raylet_address is None:
            nodes = self._gcs.call("get_nodes", alive_only=True)
            if not nodes:
                raise RuntimeError("no alive nodes in cluster")
            head = next((n for n in nodes if n["labels"].get("head")),
                        nodes[0])
            raylet_address = head["address"]
            store_name = head["store_name"]
            self.node_id = head["node_id"]
        else:
            info = RpcClient(tuple(raylet_address),
                             label="driver").call("node_info")
            store_name = info["store_name"]
            self.node_id = info["node_id"]
        self._raylet = RpcClient(tuple(raylet_address), label="driver")
        self.store = ShmObjectStore(store_name)
        self._actor_locations: dict[str, tuple] = {}   # id -> (addr, incarnation)
        self._actor_seq: dict[str, int] = {}           # id -> next seq
        # incarnation the seq numbering was issued against — tracked
        # SEPARATELY from the location cache: evicting a cached location
        # (e.g. on a transport error) must not restart numbering at 0
        # while the worker's ordered cursor sits at N, or every later
        # call is silently deduped as stale and the actor wedges
        self._actor_seq_inc: dict[str, int] = {}
        # pipelined actor submits: id -> deque[(tasks, PendingCall, addr,
        # sent_at)] — each window entry is one BATCH frame in flight
        self._actor_windows: dict[str, deque] = {}
        self._actor_gap_fillers: dict[str, list] = {}
        self._actor_reaper_started = False
        self._actor_reaper: threading.Thread | None = None
        self._seq_lock = threading.Lock()
        # submit-side coalescing: callers enqueue (task, addr) here and the
        # flusher thread packs consecutive submissions to one actor into a
        # single submit_actor_tasks frame — one pickle+syscall per BURST,
        # not per call (reference: the async gRPC CallQueue in
        # DirectActorTaskSubmitter batches sends on its io thread)
        self._actor_outbox: dict[str, list] = {}
        self._actor_unacked: dict[str, int] = {}   # flow control (tasks)
        self._outbox_cv = threading.Condition()
        # Registration coalescer (same shape as the ref flusher): N
        # create_actor calls become one register_actors frame. Anonymous
        # creations return as soon as the entry is enqueued; named ones
        # wait for their per-entry ack (name-conflict stays a
        # synchronous ValueError).
        from ray_tpu_torch.utils.config import get_config as _gcfg0
        _pcfg = _gcfg0()
        self._reg_outbox: list[dict] = []
        self._reg_pending: set[str] = set()        # enqueued, unacked ids
        self._reg_failed: dict[str, str] = {}      # async failures by id
        self._reg_cv = threading.Condition()
        self._reg_flusher_started = False
        self._reg_linger_s = _pcfg.actor_register_linger_s
        self._reg_batch_cap = max(1, _pcfg.actor_register_batch_size)
        self._reg_window = max(1, _pcfg.actor_register_window)
        # CH_ACTOR pushed location table (reference: the core worker's
        # ActorInfoAccessor subscription — resolution is an event wait,
        # not a get_actor poll storm against the locked GCS). Only
        # top-level drivers subscribe: a pool of in-worker runtimes each
        # drinking the full actor event firehose would multiply every
        # creation flood by the worker count; workers resolve few actors
        # and keep the cached-poll path.
        self._actor_pubsub = (_pcfg.actor_pubsub_enabled
                              and "RAY_TPU_TORCH_WORKER_ID" not in _os.environ)
        self._resolve_fallback_s = max(0.05, _pcfg.actor_resolve_fallback_s)
        self._resolve_timeout_s = max(1.0, _pcfg.actor_resolve_timeout_s)
        self._actor_table: dict[str, dict] = {}
        self._actor_table_cv = threading.Condition()
        self._actor_sub = None
        self._actor_sub_lock = threading.Lock()
        self._actor_get_polls = 0   # get_actor fallback polls (tested: 0
                                    # once the pushed table is warm)
        self._named_cache: dict[str, str] = {}
        # cached per-address actor-call clients (see _actor_client)
        self._actor_clients: dict[tuple, RpcClient] = {}
        self._actor_clients_lock = threading.Lock()
        # acked-but-unresolved actor calls: the worker accepted them
        # into its queue, so the submit plane forgot them — but a crash
        # takes the queue down with the worker and nobody else will
        # ever write their return oids. The reaper sweeps this against
        # the pushed actor table and fails the refs of DEAD actors with
        # a typed ActorDiedError (actor_hex -> task_id -> (oids, inc)).
        self._actor_inflight: dict[str, dict[str, tuple]] = {}
        self._inflight_lock = threading.Lock()
        from ray_tpu_torch.utils.config import get_config as _gc
        self._actor_client_cap = _gc().actor_client_cache_size
        self._actor_client_soft_cap = _gc().actor_client_soft_cap
        self.metrics: dict[str, Any] = {}
        # Lineage for object reconstruction (reference: ReferenceCounter
        # lineage pinning reference_count.h:67-115 + TaskManager::
        # ResubmitTask task_manager.h:234 + ObjectRecoveryManager
        # object_recovery_manager.h:41): return oid -> the wire task that
        # created it, so a lost object (its node died) can be re-computed
        # by re-running the task. Actor-task results are NOT recorded
        # (actor state is restored via actor restart, not re-execution).
        self._lineage: dict[str, dict] = {}
        self._lineage_lock = threading.Lock()
        self._reconstructing: set[str] = set()
        from ray_tpu_torch.utils.config import get_config
        self._lineage_grace_s = get_config().lineage_resubmit_grace_s
        self._lineage_max = get_config().lineage_max_entries
        self._pending_grace_s = get_config().task_pending_resubmit_grace_s
        # Owner-side worker leases for default-strategy tasks (reference:
        # direct_task_transport.cc): direct worker push with synchronous
        # loss detection; placement-constrained tasks fall back to the
        # raylet queue via _legacy_submit.
        from ray_tpu_torch.runtime.lease import LeaseManager
        self._closed = False
        self._fn_blobs: dict[int, tuple] = {}   # id(fn) -> (fn, blob)
        self._leases = LeaseManager(
            self._raylet,
            legacy_submit=self._legacy_submit,
            on_task_failed=self._fail_task_returns,
            on_direct_results=self._accept_direct_results,
        )
        # --- distributed refcounting (reference: reference_count.h:61;
        # see runtime/refcount.py): this runtime flushes the process's
        # ref deltas to the GCS and doubles as the client heartbeat that
        # scopes actor lifetimes. Inside a pool worker the Worker loop
        # already owns the process flush channel — skip ours. ---
        from ray_tpu_torch.runtime import refcount as _refcount
        from ray_tpu_torch.utils.config import get_config as _get_config
        _cfg = _get_config()
        self._refs = _refcount.global_counter
        self._ref_enabled = _cfg.ref_counting_enabled
        self._ref_interval = _cfg.ref_flush_interval_s
        self._ref_send_lock = threading.Lock()
        self._actor_window = _cfg.actor_submit_window
        # batched put-pin reports (see put/_put_report_loop)
        self._put_report_buf: list[tuple[str, int]] = []
        # direct results that failed placement on a full store, parked
        # for retry by the flusher (never silently dropped)
        self._direct_retry: list[tuple[str, bytes]] = []
        self._put_report_cv = threading.Condition()
        # In-process memory store for small direct task returns
        # (reference: CoreWorkerMemoryStore, memory_store.h:43): encoded
        # payloads keyed by oid hex, ZERO store/raylet/GCS traffic per
        # object. Entries are evicted when their refs die (refcount
        # release hook) and PROMOTED to the shm store the moment their
        # ref is serialized off-process (serialize hook) so remote
        # consumers always find a cluster-visible copy. Requires ref
        # counting (the death signal); disabled with it.
        self._memstore: dict[str, bytes] = {}
        self._mem_cv = threading.Condition()   # direct-result arrivals
        self._mem_arrivals = 0                 # arrival epoch (see get)
        # refs serialized off-process BEFORE their object arrived (a
        # pending task's return passed straight into another task): the
        # object must become cluster-visible the moment it lands, or the
        # consuming worker never finds it. _mem_cv guards the
        # check-miss-then-mark vs update-then-check interleavings.
        self._promote_pending: set[str] = set()
        self._use_memstore = self._ref_enabled
        self._memstore_put_limit = _cfg.max_direct_call_object_size
        if self._use_memstore:
            self._memstore_release_hook = self._evict_mem_objects
            self._memstore_serialize_hook = self._promote_mem_object
            self._refs.add_release_hook(self._memstore_release_hook)
            self._refs.add_serialize_hook(self._memstore_serialize_hook)
        threading.Thread(target=self._put_report_loop, daemon=True,
                         name="put-report-flusher").start()
        # a nested in-worker runtime must NOT claim: the Worker loop owns
        # the process flush channel (claim_flusher(worker_id) would
        # spuriously succeed for us since client_id == worker_id, and our
        # shutdown() would then unregister the still-running worker)
        in_worker = "RAY_TPU_TORCH_WORKER_ID" in _os.environ
        self._owns_flusher = (self._ref_enabled and not in_worker
                              and _refcount.claim_flusher(self.client_id))
        if self._owns_flusher:
            try:
                self._gcs.call("register_client", client_id=self.client_id,
                               kind="driver")
            except Exception:  # noqa: BLE001 - reconnecting client retries
                pass
            threading.Thread(target=self._ref_flush_loop, daemon=True,
                             name="ref-flusher").start()

    # ------------------------------------------------------------------
    # refcount flushing
    # ------------------------------------------------------------------

    def _ref_flush_loop(self):
        from ray_tpu_torch.utils.config import get_config

        period = get_config().ref_heartbeat_interval_s
        last_beat = time.monotonic()
        while not self._closed:
            # event-driven: block until ref activity or the heartbeat is
            # due (an empty update keeps the client-liveness heartbeat
            # alive — actor lifetimes hang off it)
            remain = period - (time.monotonic() - last_beat)
            if self._refs.wait_pending(max(remain, 0.05)):
                time.sleep(self._ref_interval)   # coalesce into one RPC
            if self._closed:
                return
            now = time.monotonic()
            beat = now - last_beat >= period
            if self._ref_flush_now(force_heartbeat=beat) or beat:
                last_beat = now
            if beat:
                self._sweep_promote_pending()

    def _sweep_promote_pending(self):
        """Drop promotion-on-arrival promises whose objects became
        cluster-visible some other way (large returns land in the
        executing node's shm + location directory, never through the
        direct-return path) — without this sweep a long-lived driver
        passing pending refs into tasks grows the set without bound."""
        with self._mem_cv:
            candidates = list(self._promote_pending)
        if not candidates:
            return
        visible = [o for o in candidates
                   if self.store.contains(bytes.fromhex(o))]
        remote = [o for o in candidates if o not in set(visible)]
        if remote:
            try:
                locs = self._gcs.call("get_object_locations", oids=remote)
                visible += [o for o, nodes in locs.items() if nodes]
            except Exception:  # noqa: BLE001 - GCS busy: next beat
                pass
        if visible:
            with self._mem_cv:
                self._promote_pending.difference_update(visible)

    def _ref_flush_now(self, force_heartbeat: bool = False) -> bool:
        """Send pending ref deltas (serialized by a lock so the loop and
        synchronous borrower flushes never interleave a payload). The
        protocol round itself is refcount.flush_once, shared with the
        worker loop; this wrapper adds the driver-only lineage cleanup."""
        if not self._ref_enabled or self._closed:
            return False
        from ray_tpu_torch.runtime.refcount import flush_once

        def call(method, **kwargs):
            if kwargs.get("remove"):
                # dropped refs lose reconstructability too (the object
                # is gone; resurrecting it would leak)
                with self._lineage_lock:
                    for oid_hex in kwargs["remove"]:
                        self._lineage.pop(oid_hex, None)
            return self._gcs.call(method, **kwargs)

        with self._ref_send_lock:
            return flush_once(self._refs, call, self.client_id, "driver",
                              force_heartbeat)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------

    def put(self, value) -> ObjectRef:
        """Small values land in the owner's in-process MEMORY store
        (reference: small ``ray.put`` objects live in the owner's
        CoreWorkerMemoryStore, memory_store.h:43) — zero store/raylet
        RPCs; the serialize/arrival hooks promote to shm the moment the
        ref travels off-process. Large values seal into shm with a held
        read ref; the pin registration is BATCHED (one raylet RPC per
        flush — same protocol as the worker's task-return reports), the
        seal-hold keeping the object eviction-safe until the pin lands."""
        oid = ObjectID.from_random()
        if self._use_memstore:
            payload, obj, caught = object_codec.encode_bytes(
                value, limit=self._memstore_put_limit)
            if payload is not None:
                oid_hex = oid.hex()
                self._memstore[oid_hex] = payload
                if caught:
                    # the put value contains ObjectRefs: contains-edges
                    # anchor on the outer oid (same as direct returns)
                    self._refs.add_contains(oid_hex, caught)
                return ObjectRef(oid)
            # too large for the memory tier: reuse the serialized form
            size = object_codec.put_value_durable(
                self.store, oid.binary(), value, hold=True,
                preserialized=obj, contained=caught,
                request_space=lambda n: self._raylet.call(
                    "request_space", nbytes=n))
        else:
            size = object_codec.put_value_durable(
                self.store, oid.binary(), value, hold=True,
                request_space=lambda n: self._raylet.call("request_space",
                                                          nbytes=n))
        if size > 0:
            with self._put_report_cv:
                self._put_report_buf.append((oid.hex(), size))
                self._put_report_cv.notify()
        return ObjectRef(oid)

    def _evict_mem_objects(self, oids: list):
        """Refcount release hook: every local ref to these oids died —
        drop the in-process copies (the authoritative release of any
        PROMOTED shm copy rides the normal ref protocol)."""
        pop = self._memstore.pop
        for oid_hex in oids:
            pop(oid_hex, None)

    def _promote_mem_object(self, oid_hex: str):
        """Serialize hook: an ObjectRef is being pickled (task arg, put
        payload, client channel...). If its object lives only in this
        process's memory store, write it through to the shm store + pin
        report NOW — the serialized ref may travel to a process that can
        only resolve cluster-visible objects. Runs before the enclosing
        dumps() returns, so promotion always precedes the send. A ref
        serialized BEFORE its direct return arrived is marked for
        promotion-on-arrival instead (the object exists nowhere yet;
        when the push reply lands it must go cluster-visible, not just
        into this process's memory)."""
        if self._closed:
            return
        with self._mem_cv:
            payload = self._memstore.get(oid_hex)
            if payload is None:
                # not here yet: if it's not already cluster-visible,
                # promote when (if ever) it arrives as a direct return
                if not self.store.contains(bytes.fromhex(oid_hex)):
                    self._promote_pending.add(oid_hex)
                return
        from ray_tpu_torch._private.shm_store import (ObjectExistsError,
                                                StoreFullError)

        try:
            object_codec.put_raw(self.store, bytes.fromhex(oid_hex),
                                 payload, hold=True)
        except ObjectExistsError:
            return  # already cluster-visible
        except StoreFullError:
            try:
                self._raylet.call("request_space", nbytes=len(payload))
                object_codec.put_raw(self.store, bytes.fromhex(oid_hex),
                                     payload, hold=True)
            except Exception:  # noqa: BLE001 - keep the mem copy; a
                return        # remote consumer degrades to ObjectLost
        with self._put_report_cv:
            self._put_report_buf.append((oid_hex, len(payload)))
            self._put_report_cv.notify()

    def _accept_direct_results(self, results: dict):
        """Small task returns that rode the push reply (reference: the
        owner's in-process memory store for direct-call returns,
        memory_store.h:43): land each in the process-local memory store
        — no shm write, no pin RPC, no location tracking. Falls back to
        the durable shm path when ref counting is off (nothing would
        ever evict the memory copies)."""
        if self._use_memstore and not self._closed:
            with self._mem_cv:
                self._memstore.update(results)
                self._mem_arrivals += 1
                promote = ([o for o in results
                            if o in self._promote_pending]
                           if self._promote_pending else ())
                self._promote_pending.difference_update(promote)
                self._mem_cv.notify_all()
            for oid_hex in promote:
                self._promote_mem_object(oid_hex)
            # every local ref may have died while a result was in flight
            # (submit-and-forget chains): the release hook already fired
            # for those oids, so no death notice will ever come again —
            # any copy kept now leaks the memstore forever. Applies to
            # EVERY arriving oid, not just promote-pending ones (a
            # promoted shm copy serves any remote consumer).
            dead = [o for o in results if self._refs.count(o) == 0]
            if dead:
                with self._mem_cv:
                    for oid_hex in dead:
                        self._memstore.pop(oid_hex, None)
            return
        from ray_tpu_torch._private.shm_store import (ObjectExistsError,
                                                StoreFullError)

        for oid_hex, payload in results.items():
            if self._closed:
                return
            oid = bytes.fromhex(oid_hex)
            placed = False
            exists = False
            for _ in range(20):
                try:
                    object_codec.put_raw(self.store, oid, payload,
                                         hold=True)
                    placed = True
                    break
                except ObjectExistsError:
                    # a racing duplicate execution already landed this
                    # result (first write won, its own report carries
                    # the pin): neither report nor park — parking would
                    # livelock the flusher on a permanent Exists
                    exists = True
                    break
                except StoreFullError:
                    try:
                        self._raylet.call("request_space",
                                          nbytes=len(payload))
                    except Exception:  # noqa: BLE001
                        pass
                    time.sleep(0.02)
            if placed:
                with self._put_report_cv:
                    self._put_report_buf.append((oid_hex, len(payload)))
                    self._put_report_cv.notify()
            elif not exists:
                # NEVER silently drop the only copy of a result: park it
                # for the put-report flusher to retry once space frees
                # (blocking this lease pusher thread longer would stall
                # its task pushes instead)
                with self._put_report_cv:
                    self._direct_retry.append((oid_hex, payload))
                    self._put_report_cv.notify()

    def _put_report_loop(self):
        """Drain put reports into batched report_objects RPCs, releasing
        each object's seal-hold once its pin is confirmed. Also retries
        parked direct results that hit a full store."""
        while not self._closed:
            retry = None
            with self._put_report_cv:
                while (not self._put_report_buf and not self._direct_retry
                       and not self._closed):
                    self._put_report_cv.wait(timeout=0.5)
                if self._direct_retry:
                    retry, self._direct_retry = self._direct_retry, []
            if self._closed:
                return
            if retry:
                self._accept_direct_results(dict(retry))
                if self._closed:
                    return
            if self._put_report_buf:
                from ray_tpu_torch.utils.config import get_config as _gc

                time.sleep(_gc().put_report_linger_s)   # coalesce burst
            with self._put_report_cv:
                batch, self._put_report_buf = self._put_report_buf, []
            if not batch:
                continue
            # One idempotency token per logical batch, held across
            # retries: a reply lost AFTER the raylet applied the pins
            # (healed partition, transient reset) makes the retry a
            # server-side no-op instead of a double-apply. The seal-holds
            # are what keep these objects alive until their pins land:
            # retry rather than releasing unpinned sole copies into LRU
            # eviction.
            import uuid as _uuid
            token = _uuid.uuid4().hex
            sent = False
            while not self._closed:
                try:
                    self._raylet.call("report_objects", entries=batch,
                                      token=token)
                    sent = True
                    break
                except Exception:  # noqa: BLE001 - raylet unreachable
                    time.sleep(0.05)
            if not sent:
                continue
            if self._closed:
                continue   # store may be unmapped: never touch
            for oid_hex, _ in batch:
                try:
                    self.store.release(bytes.fromhex(oid_hex))
                except Exception:  # noqa: BLE001
                    pass

    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        # FAST PATH: every object already local — in the process memory
        # store (direct small returns: zero syscalls) or sealed in shm
        # (local puts) — resolves through dict hits + ONE batched store
        # call instead of contains + get + release C round trips per
        # object (reference analog: the owner's in-process memory store
        # hit, memory_store.h:43). No size cap: the store's get_many /
        # release_many chunk internally (shm_store.BATCH_WINDOW), so the
        # process-shared mutex hold stays bounded per C call even for a
        # 200k-ref envelope get.
        mem = self._memstore if self._use_memstore else None
        bins = [r.id.binary() for r in refs]
        if bins is not None:
            payloads = [mem.get(r.hex()) for r in refs] if mem \
                else [None] * len(refs)
            misses = [b for b, p in zip(bins, payloads) if p is None]
            views = self.store.get_many(misses) if misses else []
            if all(v is not None for v in views):
                epoch0 = (self._refs.created_epoch()
                          if self._ref_enabled else 0)
                out = []
                err = None
                it = iter(views)
                try:
                    for p in payloads:
                        v = memoryview(p) if p is not None else next(it)
                        value, is_error = object_codec.decode_view(v)
                        if is_error:
                            err = value
                            break
                        out.append(value)
                finally:
                    del views, it
                    if misses:
                        self.store.release_many(misses)
                if err is not None:
                    raise err
                if self._ref_enabled and \
                        self._refs.created_epoch() != epoch0:
                    self._ref_flush_now()
                return out
            # drop the partial hits' read refs; the slow path re-reads
            # per object as each becomes local
            hits = [b for b, v in zip(misses, views) if v is not None]
            del views
            if hits:
                self.store.release_many(hits)
        oids = [r.id.hex() for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = [o for o in oids if not (mem and o in mem)
                   and not self.store.contains(bytes.fromhex(o))]
        recover_tick = 0.0
        mem_skips = 0
        while pending:
            # Local completions (direct small returns, same-host tasks)
            # resolve with a cheap contains scan — only a WINDOW of the
            # truly-unresolved set goes to the raylet per cycle.
            # Shipping the full pending list (200k oids = multi-MB
            # frames + full-set wave loops server-side) melted large
            # gets; _read_local re-pulls per object anyway, so the
            # window is a locality warmer, not a correctness gate.
            # Re-filter BEFORE the deadline check: a final ensure_local
            # that localized everything while eating the budget must
            # exit success, not GetTimeoutError.
            pending = [o for o in pending if not (mem and o in mem)
                       and not self.store.contains(bytes.fromhex(o))]
            if not pending:
                break
            if deadline is not None and deadline - time.monotonic() <= 0:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {len(pending)} objects")
            # Two arrival planes, two waits. Direct returns land in the
            # process MEMORY store, which the raylet cannot observe —
            # parking inside the raylet while they piled up locally ate
            # its whole timeout. So: wait briefly on the direct-arrival
            # cv; only when that plane is quiet (no notify AND no
            # arrival since), park in the raylet's ensure_local, which
            # wakes event-driven on local shm seals and triggers remote
            # pulls. A direct result landing mid-park costs at most the
            # 0.25 s park timeout.
            if self._use_memstore:
                with self._mem_cv:
                    arrivals0 = self._mem_arrivals
                    woke = self._mem_cv.wait(timeout=0.02)
                # BOUNDED skip: a sustained direct-result stream wakes
                # this cv every cycle, and skipping ensure_local on
                # every wake would starve the remote-pull path forever
                # (a shm-only object on another node never gets its pull
                # issued). At most ~5 consecutive wakes (~100 ms) defer
                # the ensure_local window.
                if (woke or self._mem_arrivals != arrivals0) \
                        and mem_skips < 5:
                    mem_skips += 1
                    continue
            mem_skips = 0
            # short park only when the direct-arrival blind spot exists
            # (memstore on): without it the raylet's event-driven wait
            # covers every arrival path, and 0.25s parks would 8x the
            # blocked-get RPC churn for nothing
            step = 0.25 if self._use_memstore else 2.0
            if deadline is not None:
                step = min(step, max(deadline - time.monotonic(), 0.01))
            window = pending[:4096]
            leftover = self._raylet.call("ensure_local", oids=window,
                                         timeout_s=step)
            now = time.monotonic()
            if leftover and now - recover_tick >= 2.0:
                recover_tick = now
                self._recover_lost(leftover)
        out = []
        epoch0 = self._refs.created_epoch() if self._ref_enabled else 0
        for oid_hex in oids:
            out.append(self._read_local(oid_hex, deadline))
        if self._ref_enabled and self._refs.created_epoch() != epoch0:
            # the values carried nested ObjectRefs (this process just
            # became a borrower): register the holds synchronously so
            # the owner dropping the outer cannot free the inners first
            self._ref_flush_now()
        return out

    # ------------------------------------------------------------------
    # lineage reconstruction
    # ------------------------------------------------------------------

    def _recover_lost(self, oids: list[str], depth: int = 0):
        """Re-run creating tasks from lineage (reference:
        ObjectRecoveryManager::RecoverObject object_recovery_manager.h:90
        → TaskManager::ResubmitTask) for two loss modes:

        1. Tombstoned objects: the GCS once knew them and every location
           died with its node — deterministic loss, budgeted by
           max_retries.
        2. Presumed-lost pending tasks: output never registered anywhere
           and the submission is older than the pending grace (the task
           was queued/running on a node that died — no object existed to
           tombstone). Heuristic: a merely slow task gets a DUPLICATE
           submission (harmless via first-write-wins), capped by its own
           small budget that does NOT consume the max_retries lineage
           budget."""
        uniq = list(set(oids))
        lost = self._gcs.call("get_lost_objects", oids=uniq)
        # LEGACY-path tasks lost IN FLIGHT leave no tombstone (their output
        # never existed): a pending object with lineage, no location
        # anywhere, and a stale submission is presumed dead-with-its-node
        # and resubmitted (idempotent: first-write-wins). Lease-path tasks
        # never enter this heuristic — their owner observes the lease
        # connection break synchronously and retries/fails on the spot.
        lost_set = set(lost)
        unlocated = [o for o, locs in self._gcs.call(
            "get_object_locations", oids=uniq).items()
            if not locs and o not in lost_set]
        now = time.monotonic()
        for oid_hex in unlocated:
            with self._lineage_lock:
                entry = self._lineage.get(oid_hex)
            if entry is None:
                continue
            # eligible: legacy-path tasks (no lease watches them), or
            # lease-path tasks that COMPLETED (their object existed; the
            # node died before the batched location flush — nothing is
            # watching anymore). A lease-path task still running is
            # watched by its lease connection: never resubmit on time.
            if not (entry.get("legacy") or entry["task"].get("_completed")):
                continue
            ref_t = max(entry.get("submitted_at", 0.0),
                        entry.get("last_resubmit", 0.0))
            if now - ref_t <= self._pending_grace_s:
                continue
            if entry.get("pending_resubmits", 0) >= 3:
                # duplicate budget spent: keep WAITING (the original or a
                # duplicate may still be running — raising here would
                # fail healthy long tasks). Callers bound the wait with
                # get(timeout=...); max_retries=0 tasks have no lineage
                # entry at all, so in-flight loss there also surfaces as
                # a timeout (the reference detects that case through its
                # worker-lease channel, which this design doesn't have).
                continue
            with self._lineage_lock:
                entry["pending_resubmits"] = 1 + entry.get(
                    "pending_resubmits", 0)
            self._reconstruct(oid_hex, depth, pending_grace=True)
        for oid_hex in lost:
            if self.store.contains(bytes.fromhex(oid_hex)):
                continue
            with self._lineage_lock:
                entry = self._lineage.get(oid_hex)
                reconstructing = oid_hex in self._reconstructing
            if entry is None:
                raise exc.ObjectLostError(
                    oid_hex,
                    "all copies lost with their node and no lineage is "
                    "available to reconstruct it (max_retries=0?)")
            if (entry["attempts"] <= 0 and not reconstructing
                    and time.monotonic() - entry.get("last_resubmit", 0.0)
                    > self._lineage_grace_s):
                raise exc.ObjectLostError(
                    oid_hex, "lineage re-execution budget exhausted")
            self._reconstruct(oid_hex, depth)

    def _reconstruct(self, oid_hex: str, depth: int = 0,
                     pending_grace: bool = False):
        if depth > 10:
            return
        with self._lineage_lock:
            entry = self._lineage.get(oid_hex)
            if entry is None:
                return
            if not pending_grace and entry["attempts"] <= 0:
                return
            if oid_hex in self._reconstructing:
                return
            # a re-execution is likely still running — don't stack another
            # (the tombstone only clears when the new copy registers).
            # Known limit: a re-run longer than the grace gets a duplicate
            # submission; first-write-wins keeps that harmless. The
            # pending-task path uses its own (shorter) grace, already
            # checked by the caller against submit/resubmit time.
            grace = (self._pending_grace_s if pending_grace
                     else self._lineage_grace_s)
            if (time.monotonic() - entry.get("last_resubmit", 0.0)
                    < grace):
                return
            if not pending_grace:
                # only DETERMINISTIC loss consumes the max_retries budget;
                # heuristic pending resubmits have their own cap
                entry["attempts"] -= 1
            entry["last_resubmit"] = time.monotonic()
            self._reconstructing.add(oid_hex)
        try:
            # deps first: a re-run will fail on lost inputs (recursive
            # lineage re-execution, depth-bounded)
            deps = entry["deps"]
            if deps:
                dep_lost = self._gcs.call("get_lost_objects", oids=deps)
                for dep in dep_lost:
                    if not self.store.contains(bytes.fromhex(dep)):
                        self._reconstruct(dep, depth + 1)
            # first-write-wins makes a duplicate re-execution harmless.
            # Strip the completion marker: the COPY is a fresh attempt,
            # and a stale _completed=True would disable the lease-break
            # retry/fail path for it.
            resubmit = dict(entry["task"])
            resubmit.pop("_completed", None)
            self._leases.submit(resubmit)
        finally:
            with self._lineage_lock:
                self._reconstructing.discard(oid_hex)

    def _read_local(self, oid_hex: str, deadline):
        """Read a locally-available object; if it was evicted between the
        ensure_local and the read (LRU pressure), re-pull and retry."""
        from ray_tpu_torch._private.shm_store import ObjectNotFoundError

        if self._use_memstore:
            payload = self._memstore.get(oid_hex)
            if payload is not None:
                value, is_error = object_codec.decode_view(
                    memoryview(payload))
                if is_error:
                    raise value
                return value
        for _ in range(3):
            try:
                value, is_error = object_codec.get_value(
                    self.store, bytes.fromhex(oid_hex), timeout_ms=0)
            except ObjectNotFoundError:
                step = 5.0
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        raise exc.GetTimeoutError(
                            f"object {oid_hex[:8]} evicted and re-pull "
                            f"timed out") from None
                    step = min(step, remain)
                self._raylet.call("ensure_local", oids=[oid_hex],
                                  timeout_s=step)
                continue
            if is_error:
                raise value
            return value
        raise exc.ObjectLostError(oid_hex, "evicted repeatedly under "
                                  "store memory pressure")

    def wait(self, refs, num_returns=1, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list = []
        not_ready = list(refs)
        mem = self._memstore if self._use_memstore else None
        while True:
            still = []
            for r in not_ready:
                if (mem and r.id.hex() in mem) or \
                        self.store.contains(r.id.binary()):
                    ready.append(r)
                else:
                    still.append(r)
            not_ready = still
            if len(ready) >= num_returns or not not_ready:
                break
            # check remote locations for objects created elsewhere
            oids = [r.id.hex() for r in not_ready]
            locs = self._gcs.call("get_object_locations", oids=oids)
            for r in list(not_ready):
                if locs.get(r.id.hex()):
                    ready.append(r)
                    not_ready.remove(r)
            if len(ready) >= num_returns or not not_ready:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        return ready, not_ready

    def free(self, refs: list):
        """Release object memory cluster-wide AND drop lineage, so the
        objects cannot be reconstructed (reference: ray.internal.free)."""
        oids = [r.id.hex() for r in refs]
        with self._lineage_lock:
            for o in oids:
                self._lineage.pop(o, None)
        for o in oids:
            self._memstore.pop(o, None)
        try:
            self._raylet.call("free_objects", oids=oids)
        except (OSError, ConnectionLost):
            pass

    def cancel(self, ref: ObjectRef, force: bool = False):
        """Best-effort task cancellation (reference ``ray.cancel``):
        queued tasks are dequeued, running tasks interrupted (``force``:
        worker killed); consumers of the return object observe
        ``TaskCancelledError``. Finished tasks are untouched."""
        # lease-managed tasks are invisible to the raylet queues — the
        # owner cancels them itself
        hit = self._leases.cancel({ref.id.hex()}, force=force)
        if hit is not None:
            state, task = hit
            if state == "queued":
                self._seal_cancel_error(task)
            return
        try:
            self._raylet.call("cancel_task", oids=[ref.id.hex()],
                              force=force)
        except (OSError, ConnectionLost):
            pass

    def _seal_cancel_error(self, task: dict):
        self._fail_task_returns(task, exc.TaskCancelledError(
            f"task {task.get('name', '?')} cancelled while queued"))

    def note_return_owner(self, spec: TaskSpec):
        pass  # ownership is tracked centrally (GCS object directory)

    # ------------------------------------------------------------------
    # tasks
    # ------------------------------------------------------------------

    _EMPTY_ARGS_BLOB = serialization.dumps(([], {}))

    def _wire_args(self, spec: TaskSpec, pin_sink: set | None = None):
        """Replace top-level ObjectRefs with markers (reference semantics:
        only top-level args are resolved before execution). Plain-data
        args take plain ``pickle.dumps``; the rest go through the port's
        pickler (tensors out of band, the driver's ``__main__`` by file
        path).

        ``pin_sink``: collects the oid of every ref the task depends on
        (top-level markers AND refs nested inside arg containers, found
        via serialization capture) so the submitter can pin them for the
        task's lifetime (reference: submitted-task references,
        reference_count.h:61)."""
        if not spec.args and not spec.kwargs:
            return self._EMPTY_ARGS_BLOB
        args = [("__objref__", a.hex()) if isinstance(a, ObjectRef) else a
                for a in spec.args]
        kwargs = {k: ("__objref__", v.hex()) if isinstance(v, ObjectRef)
                  else v for k, v in spec.kwargs.items()}
        if self._use_memstore:
            # top-level ref args never hit ObjectRef.__reduce__ (markers
            # replace them before pickling), so the serialize-hook
            # promotion doesn't fire — promote memory-store residents
            # (or mark not-yet-arrived results promote-on-arrival)
            # here: the executing worker resolves args from the
            # cluster-visible store
            for a in spec.args:
                if isinstance(a, ObjectRef):
                    self._promote_mem_object(a.hex())
            for v in spec.kwargs.values():
                if isinstance(v, ObjectRef):
                    self._promote_mem_object(v.hex())
        if pin_sink is not None:
            pin_sink.update(a[1] for a in args
                            if type(a) is tuple and len(a) == 2
                            and a[0] == "__objref__")
            pin_sink.update(v[1] for v in kwargs.values()
                            if type(v) is tuple and len(v) == 2
                            and v[0] == "__objref__")
        # The plain-pickle fast path is gated to builtin SCALARS only: a
        # container could hide a tensor or a __main__-defined class, which
        # need the port's pickler.
        if all(type(a) in _SCALAR_TYPES
               or (type(a) is tuple and len(a) == 2 and a[0] == "__objref__")
               for a in args) and all(
                   type(v) in _SCALAR_TYPES for v in kwargs.values()):
            import pickle
            return pickle.dumps((args, kwargs), protocol=5)
        # nested refs inside containers surface through the capture hook
        with self._refs.capture() as cap:
            blob = _dumps_or_type_error((args, kwargs), spec.function_name,
                                        "its arguments")
        if pin_sink is not None:
            pin_sink.update(cap.oids)
        return blob

    def _function_blob(self, fn):
        """Pickle-once, EXPORT-once function table (reference:
        ``_private/function_manager.py:228`` — each function is exported
        to the GCS once; executors fetch by id and cache). Tasks then
        carry only the 16-byte content id: at 10k+ submits/s, shipping
        the ~500-byte closure blob per task (and hashing it per task on
        the worker) was a measurable slice of the frame encode/decode.

        Returns ``(fn_id, closure_oids)`` — ObjectRefs captured in the
        function's CLOSURE are task dependencies too: every submit pins
        them alongside the args (the cache keeps the captured set, so
        repeat submits pin without re-pickling)."""
        key = id(fn)
        hit = self._fn_blobs.get(key)
        if hit is not None and hit[0] is fn:
            return hit[1], hit[2]
        import hashlib

        with self._refs.capture() as cap:
            blob = _dumps_or_type_error(
                fn, getattr(fn, "__qualname__", repr(fn)), "the function")
        closure_oids = frozenset(cap.oids)
        fn_id = hashlib.blake2b(blob, digest_size=16).hexdigest()
        # registration must land BEFORE any task referencing the id is
        # pushed (synchronous; once per function per driver). Content-
        # addressed: re-registering the same id is an idempotent no-op.
        self._gcs.call("kv_put", ns="__functions__", key=fn_id, value=blob)
        from ray_tpu_torch.utils.config import get_config as _gc

        if len(self._fn_blobs) > _gc().fn_export_cache_size:
            self._fn_blobs.clear()
        # fn ref pins id(fn) stable
        self._fn_blobs[key] = (fn, fn_id, closure_oids)
        return fn_id, closure_oids

    def submit_task(self, spec: TaskSpec) -> list[ObjectRef]:
        streaming = spec.num_returns in ("streaming", "dynamic")
        if streaming:
            # end-of-stream count object = the declared return id: lease
            # breaks / worker deaths seal their error exactly where the
            # consumer's end check reads (runtime/streaming.py). Streams
            # are not retried (a partially consumed stream is not
            # idempotently re-runnable), so no lineage entry either.
            from ray_tpu_torch.runtime.streaming import (ObjectRefGenerator,
                                                   stream_end_ref)
            spec.return_ids = [stream_end_ref(spec.task_id.binary()).id]
            spec.max_retries = 0
        else:
            spec.return_ids = [ObjectID.from_random()
                               for _ in range(spec.num_returns)]
        # The caller's ObjectRefs MUST exist before the task can reach a
        # pusher thread: _accept_direct_results reads count==0 as "every
        # ref died while the result was in flight" and drops the arriving
        # copy. A worker fast enough to reply before this thread got back
        # to construct the refs (routinely ~0.03% of a 10k-task drain on
        # a loaded host) would lose the only copy of the result, and the
        # later get() waits forever.
        out_refs = ([] if streaming
                    else [ObjectRef(oid) for oid in spec.return_ids])
        if spec.task_type == TaskType.ACTOR_TASK:
            self._submit_actor_task(spec)
        else:
            pin_oids: set = set()
            fn_id, closure_oids = self._function_blob(spec.function)
            pin_oids.update(closure_oids)
            task = {
                "task_id": spec.task_id.hex(),
                "name": spec.function_name,
                "function_id": fn_id,
                "args_blob": self._wire_args(spec, pin_oids),
                "return_oids": [o.hex() for o in spec.return_ids],
                "resources": dict(spec.resources.resources),
                "strategy": _wire_strategy(spec),
                "max_retries": spec.max_retries,
                "runtime_env": spec.runtime_env,
                "namespace": self._effective_namespace(),
            }
            if streaming:
                task["streaming"] = True
            if pin_oids and self._ref_enabled:
                # pin the args for the task's lifetime; the executing
                # worker releases after it finishes ("pinned" tells it
                # a pin exists to release)
                task["pinned"] = True
                self._refs.add_task_pins(spec.task_id.hex(),
                                         sorted(pin_oids))
            if spec.max_retries > 0:
                deps = [a.id.hex() for a in spec.args
                        if isinstance(a, ObjectRef)]
                deps += [v.id.hex() for v in spec.kwargs.values()
                         if isinstance(v, ObjectRef)]
                entry = {"task": task, "deps": deps,
                         "attempts": spec.max_retries,
                         "submitted_at": time.monotonic()}
                with self._lineage_lock:
                    for oid in spec.return_ids:
                        self._lineage[oid.hex()] = entry
                    # bounded (reference: RAY_max_lineage_bytes caps the
                    # lineage the owner pins): oldest entries dropped —
                    # their objects simply lose reconstructability
                    while len(self._lineage) > self._lineage_max:
                        self._lineage.pop(next(iter(self._lineage)))
            self._leases.submit(task)
        if streaming:
            from ray_tpu_torch.runtime.streaming import ObjectRefGenerator
            return [ObjectRefGenerator(spec.task_id.binary())]
        return out_refs

    def _legacy_submit(self, task: dict):
        """Raylet-queue submission (placement-constrained tasks, lease
        fallbacks). These have no lease channel watching them, so their
        lineage entries opt back into the pending-grace loss heuristic."""
        with self._lineage_lock:
            for oid_hex in task.get("return_oids", ()):
                entry = self._lineage.get(oid_hex)
                if entry is not None:
                    entry["legacy"] = True
        self._raylet.call("submit_task", task=task)

    def _fail_task_returns(self, task: dict, error: BaseException):
        """A lease broke under a non-retriable task: seal error objects so
        waiters unblock (reference: TaskManager failing the task spec's
        returns). Skips oids that were completed before the break."""
        locs: dict = {}
        try:
            locs = self._gcs.call("get_object_locations",
                                  oids=list(task.get("return_oids", ())))
        except Exception:  # noqa: BLE001 - degrade to local checks
            pass
        err = (error if isinstance(error, exc.RayTpuError)
               else exc.WorkerCrashedError(
                   f"worker lease broke while executing "
                   f"{task.get('name', '?')}: {error}"))
        if task.get("pinned"):
            # the task will never run to release its arg pins itself
            self._refs.release_task_pin(task.get("task_id", ""))
        with self._mem_cv:
            # no result will ever arrive for these: drop any promised
            # promotion-on-arrival (the error object sealed below is
            # cluster-visible on its own)
            self._promote_pending.difference_update(
                task.get("return_oids", ()))
        for oid_hex in task.get("return_oids", ()):
            if locs.get(oid_hex):
                continue  # the task actually finished before the break
            oid = bytes.fromhex(oid_hex)
            if self._closed:
                return  # store may be unmapped mid-shutdown: never touch
            if oid_hex in self._memstore or self.store.contains(oid):
                continue
            try:
                size = object_codec.put_value_durable(
                    self.store, oid, err, is_error=True, hold=True,
                    request_space=lambda n: self._raylet.call(
                        "request_space", nbytes=n))
                try:
                    self._raylet.call("report_object", oid=oid_hex,
                                      size=size)
                finally:
                    if size > 0:
                        self.store.release(oid)
            except Exception:  # noqa: BLE001 - racing completion wins
                pass

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------

    def _effective_namespace(self, override: str | None = None) -> str:
        if override:
            return override
        from ray_tpu_torch.runtime_context import current_task_namespace

        return current_task_namespace() or self.namespace

    def create_actor(self, spec: TaskSpec, name: str | None = None,
                     namespace: str | None = None,
                     lifetime: str | None = None) -> ActorID:
        actor_id = ActorID.from_random()
        spec.actor_id = actor_id
        ns = self._effective_namespace(namespace)
        pin_oids: set = set()
        with self._refs.capture() as _cls_cap:
            cls_blob = _dumps_or_type_error(
                spec.function, spec.function_name, "the actor class")
        pin_oids.update(_cls_cap.oids)
        creation = {
            "task_id": spec.task_id.hex(),
            "name": spec.function_name,
            "function_blob": cls_blob,
            "args_blob": self._wire_args(spec, pin_oids),
            "return_oids": [ObjectID.from_random().hex()],
            "resources": dict(spec.resources.resources),
            "max_concurrency": spec.max_concurrency,
            "runtime_env": spec.runtime_env,
            "namespace": ns,
        }
        if pin_oids and self._ref_enabled:
            creation["pinned"] = True
            self._refs.add_task_pins(spec.task_id.hex(), sorted(pin_oids))
            # the pin must exist at the GCS before the raylet-hosted
            # creation task can finish and release it
            self._ref_flush_now()
        strategy = _wire_strategy(spec)
        entry = {
            "kwargs": {
                "actor_id": actor_id.hex(), "name": name,
                "creation_spec": creation,
                "resources": dict(spec.resources.resources),
                "max_restarts": spec.max_restarts,
                "pg_id": strategy.get("pg_id"),
                "namespace": ns,
                "owner_id": self.client_id if self._ref_enabled else None,
                "lifetime": lifetime,
            },
            # named registrations stay synchronous: the name-conflict
            # ValueError must surface from THIS call, not a later one
            "ev": threading.Event() if name is not None else None,
            "error": None,
        }
        # subscribe BEFORE the registration can produce events, so the
        # alive push is never lost to the subscribe race
        self._ensure_actor_sub()
        with self._reg_cv:
            while (len(self._reg_pending) >= self._reg_window
                   and not self._closed):
                self._reg_cv.wait(timeout=0.1)
            self._reg_outbox.append(entry)
            self._reg_pending.add(actor_id.hex())
            self._reg_cv.notify_all()
        self._ensure_reg_flusher()
        if entry["ev"] is not None:
            entry["ev"].wait(timeout=60.0)
            if entry["error"] is not None:
                raise ValueError(entry["error"])
        return actor_id

    # -- registration coalescer ----------------------------------------

    def _ensure_reg_flusher(self):
        if self._reg_flusher_started:
            return
        with self._reg_cv:
            if self._reg_flusher_started:
                return
            self._reg_flusher_started = True
        threading.Thread(target=self._reg_flush_loop, daemon=True,
                         name="actor-register-flusher").start()

    def _reg_flush_loop(self):
        while not self._closed:
            with self._reg_cv:
                while not self._reg_outbox and not self._closed:
                    self._reg_cv.wait(timeout=0.2)
                if self._closed:
                    batch = self._reg_outbox
                    self._reg_outbox = []
                else:
                    batch = None
            if batch is not None:   # shutdown: fail the stragglers
                self._reg_fail_batch(batch, "runtime shut down")
                return
            if self._reg_linger_s > 0:
                time.sleep(self._reg_linger_s)   # coalesce the burst
            with self._reg_cv:
                batch = self._reg_outbox[:self._reg_batch_cap]
                self._reg_outbox = self._reg_outbox[self._reg_batch_cap:]
            if not batch:
                continue
            try:
                reply = self._gcs.call(
                    "register_actors",
                    actors=[e["kwargs"] for e in batch])
                results = reply["results"]
            except Exception as e:  # noqa: BLE001 - redial window burned
                self._reg_fail_batch(batch, repr(e))
                continue
            with self._reg_cv:
                for entry, res in zip(batch, results):
                    aid = entry["kwargs"]["actor_id"]
                    self._reg_pending.discard(aid)
                    if not res.get("ok"):
                        err = res.get("error", "registration failed")
                        entry["error"] = err
                        self._reg_failed[aid] = err
                    if entry["ev"] is not None:
                        entry["ev"].set()
                self._reg_cv.notify_all()

    def _reg_fail_batch(self, batch: list, err: str):
        with self._reg_cv:
            for entry in batch:
                aid = entry["kwargs"]["actor_id"]
                self._reg_pending.discard(aid)
                entry["error"] = err
                self._reg_failed[aid] = err
                if entry["ev"] is not None:
                    entry["ev"].set()
            self._reg_cv.notify_all()

    def _reg_drain(self, actor_id_hex: str, timeout: float = 10.0):
        """Block until this actor's registration frame has been acked
        (ordering guard for kill/lookup racing the coalescer)."""
        deadline = time.monotonic() + timeout
        with self._reg_cv:
            while (actor_id_hex in self._reg_pending
                   and time.monotonic() < deadline and not self._closed):
                self._reg_cv.wait(timeout=0.1)

    # -- pushed actor-location table (CH_ACTOR subscription) -----------

    def _ensure_actor_sub(self) -> bool:
        if not self._actor_pubsub or self._closed:
            return False
        if self._actor_sub is not None:
            return True
        with self._actor_sub_lock:
            if self._actor_sub is None and not self._closed:
                from ray_tpu_torch.runtime.rpc import PushSubscriber

                self._actor_sub = PushSubscriber(
                    self.gcs_address,
                    {"method": "subscribe", "channels": ["actor"]},
                    self._on_actor_event,
                    reconnect=True,   # survive a GCS restart
                    label="driver")
        return True

    def _on_actor_event(self, msg: dict):
        events = msg.get("batch") or (msg,)
        with self._actor_table_cv:
            for ev in events:
                aid = ev.get("actor_id")
                kind = ev.get("event")
                if aid is None or kind is None:
                    continue
                if kind == "alive":
                    self._actor_table[aid] = {
                        "state": "ALIVE",
                        "address": ev.get("address"),
                        "push_addr": ev.get("push_addr"),
                        "num_restarts": ev.get("num_restarts", 0)}
                elif kind == "restarting":
                    self._actor_table[aid] = {"state": "RESTARTING"}
                    self._actor_locations.pop(aid, None)
                elif kind == "dead":
                    self._actor_table[aid] = {
                        "state": "DEAD",
                        "death_reason": ev.get("reason", "dead")}
                    self._actor_locations.pop(aid, None)
            self._actor_table_cv.notify_all()

    def _install_location(self, actor_id_hex: str, addr, num_restarts):
        entry = (tuple(addr), num_restarts)
        with self._seq_lock:
            if self._actor_seq_inc.get(actor_id_hex) != entry[1]:
                self._actor_seq[actor_id_hex] = 0
                self._actor_seq_inc[actor_id_hex] = entry[1]
            self._actor_locations[actor_id_hex] = entry
        return entry

    def _actor_location(self, actor_id_hex: str,
                        timeout: float | None = None):
        """(address, incarnation) of an ALIVE actor — the DIRECT worker
        push port when the actor has one (reference:
        DirectActorTaskSubmitter dials the actor process, no raylet hop),
        else its raylet. Caches, and resets the caller-side sequence
        numbering when a new incarnation is observed (restarted actors
        start their ordering from 0)."""
        cached = self._actor_locations.get(actor_id_hex)
        if cached is not None:
            return cached
        return self._actor_location_miss(actor_id_hex, timeout)

    def _actor_location_miss(self, actor_id_hex: str,
                             timeout: float | None = None):
        """Slow path of :meth:`_actor_location`.

        Steady state is pubsub-driven: waits on the CH_ACTOR pushed
        table; a counted get_actor poll fires only after a quiet
        ``actor_resolve_fallback_s`` window (events published before the
        subscription landed, or lost across a redial)."""
        cached = self._actor_locations.get(actor_id_hex)
        if cached is not None:
            return cached
        if timeout is None:
            timeout = self._resolve_timeout_s
        deadline = time.monotonic() + timeout
        use_push = self._ensure_actor_sub()
        poll_at = (time.monotonic() + self._resolve_fallback_s
                   if use_push else time.monotonic())
        while True:
            if use_push:
                with self._actor_table_cv:
                    ent = self._actor_table.get(actor_id_hex)
                if ent is not None:
                    if ent["state"] == "ALIVE":
                        addr = ent.get("push_addr") or ent.get("address")
                        if addr is not None:
                            return self._install_location(
                                actor_id_hex, addr,
                                ent.get("num_restarts", 0))
                    elif ent["state"] == "DEAD":
                        raise exc.ActorDiedError(
                            actor_id_hex,
                            ent.get("death_reason", "dead"))
                err = self._reg_failed.get(actor_id_hex)
                if err is not None:
                    raise exc.ActorDiedError(actor_id_hex, err)
            now = time.monotonic()
            if now >= deadline:
                break
            if now >= poll_at:
                # fallback poll — the regression test asserts this
                # counter stays flat once the pushed table is warm
                self._actor_get_polls += 1
                info = self._gcs.call("get_actor", actor_id=actor_id_hex)
                if info is None:
                    if actor_id_hex in self._reg_pending:
                        # still queued in the coalescer: not an error
                        poll_at = now + self._resolve_fallback_s
                        continue
                    raise exc.ActorDiedError(actor_id_hex,
                                             "unknown actor")
                if info["state"] == "ALIVE":
                    addr = info.get("push_addr") or info["address"]
                    return self._install_location(
                        actor_id_hex, addr, info.get("num_restarts", 0))
                if info["state"] == "DEAD":
                    raise exc.ActorDiedError(
                        actor_id_hex, info.get("death_reason", "dead"))
                poll_at = now + (self._resolve_fallback_s if use_push
                                 else 0.02)
                if not use_push:
                    time.sleep(0.02)
                continue
            if use_push:
                with self._actor_table_cv:
                    self._actor_table_cv.wait(
                        timeout=min(0.2, deadline - now, poll_at - now))
        raise exc.ActorUnavailableError(
            f"actor {actor_id_hex[:8]} not ALIVE within {timeout}s")

    @property
    def ACTOR_WINDOW(self):
        """Max unacked tasks per actor (outbox + in flight); flag
        ``actor_submit_window`` — deep enough to absorb enqueue-ack
        latency without stalling the submitter."""
        return self._actor_window

    def _submit_actor_task(self, spec: TaskSpec):
        """Enqueue one actor call for the flusher (seq assigned HERE so
        caller submission order = sequence order; the worker's per-caller
        seq buffer tolerates wire reordering). Blocks only when the
        actor's unacked window is full."""
        actor_hex = spec.actor_id.hex()
        pin_oids: set = set()
        task = {
            "task_id": spec.task_id.hex(),
            "name": spec.function_name,
            "actor_id": actor_hex,
            "method_name": spec.actor_method_name,
            "args_blob": self._wire_args(spec, pin_oids),
            "return_oids": [o.hex() for o in spec.return_ids],
            "caller_id": self.caller_id,
        }
        if pin_oids and self._ref_enabled:
            task["pinned"] = True
            self._refs.add_task_pins(spec.task_id.hex(), sorted(pin_oids))
        if spec.num_returns in ("streaming", "dynamic"):
            # generator METHOD: worker-side _store_returns streams the
            # yields exactly like a generator task
            task["streaming"] = True
        try:
            addr, incarnation = self._actor_location(actor_hex)
        except (exc.ActorDiedError, exc.ActorUnavailableError, OSError,
                ConnectionLost, LookupError) as e:
            self._resend_actor_task(task, actor_hex, e, None)
            return
        with self._seq_lock:
            seq = self._actor_seq.get(actor_hex, 0)
            self._actor_seq[actor_hex] = seq + 1
        task["seq"] = seq
        task["incarnation"] = incarnation
        with self._outbox_cv:
            while (self._actor_unacked.get(actor_hex, 0)
                   >= self.ACTOR_WINDOW and not self._closed):
                self._outbox_cv.wait(timeout=0.1)
            self._actor_outbox.setdefault(actor_hex, []).append(
                (task, tuple(addr)))
            self._actor_unacked[actor_hex] = \
                self._actor_unacked.get(actor_hex, 0) + 1
            self._outbox_cv.notify_all()
        self._ensure_actor_reaper()

    def _actor_client(self, addr) -> RpcClient:
        """Cached per-address client: a fresh socket + reader thread per
        actor CALL is ruinous on polling paths (report buses poll at
        50 Hz)."""
        addr = tuple(addr)
        with self._actor_clients_lock:
            client = self._actor_clients.get(addr)
            if client is not None and not client._closed:
                return client
        # connect OUTSIDE the lock: one unreachable raylet (30s connect
        # timeout) must not stall submissions to every other node
        fresh = RpcClient(addr, label="owner")
        evicted = None
        with self._actor_clients_lock:
            client = self._actor_clients.get(addr)
            if client is not None and not client._closed:
                fresh.close()  # lost the race; reuse the winner
                return client
            self._actor_clients[addr] = fresh
            # bounded: with direct actor push, keys are per-worker ports
            # (one per actor incarnation) — a driver churning actors
            # would otherwise leak a dead client per retired actor.
            # ONLY closed entries are evicted below the hard cap:
            # closing a LIVE client drops its in-flight submit frames,
            # and at >cap live actors that cascades into an eviction/
            # resend storm that stalls the whole submission plane (the
            # 2k-actor envelope ran minutes-per-round-trip until this).
            # The hard cap is a leak backstop sized far above any sane
            # live-actor count per driver; sockets + parked reader
            # threads are cheap, lost replies are not.
            if len(self._actor_clients) > self._actor_client_soft_cap:
                for k, c in list(self._actor_clients.items()):
                    if c._closed and k != addr:
                        evicted = self._actor_clients.pop(k)
                        break
                else:
                    if len(self._actor_clients) > \
                            self._actor_client_cap:
                        oldest = next(iter(self._actor_clients))
                        if oldest != addr:
                            evicted = self._actor_clients.pop(oldest)
        if evicted is not None:
            try:
                evicted.close()
            except Exception:  # noqa: BLE001
                pass
        return fresh

    def _drop_actor_client(self, addr):
        with self._actor_clients_lock:
            client = self._actor_clients.pop(tuple(addr), None)
        if client is not None:
            client.close()

    def _flush_actor_outbox(self):
        """Flusher duty: pack each actor's queued submissions into
        submit_actor_tasks batch frames (split on address change so a
        mid-burst relocation never mixes destinations)."""
        with self._outbox_cv:
            if not self._actor_outbox:
                return
            snapshot = self._actor_outbox
            self._actor_outbox = {}
        for actor_hex, items in snapshot.items():
            window = self._actor_windows.setdefault(actor_hex, deque())
            i = 0
            while i < len(items):
                addr = items[i][1]
                batch = []
                while i < len(items) and items[i][1] == addr:
                    batch.append(items[i][0])
                    i += 1
                try:
                    client = self._actor_client(addr)
                    if len(batch) == 1:
                        pending = client.call_async("submit_actor_task",
                                                    task=batch[0])
                    else:
                        pending = client.call_async("submit_actor_tasks",
                                                    tasks=batch)
                except (exc.ActorDiedError, exc.ActorUnavailableError,
                        OSError, ConnectionLost, LookupError) as e:
                    for t in batch:
                        self._resend_actor_task(t, actor_hex, e, addr)
                    self._ack_actor_tasks(actor_hex, len(batch))
                    continue
                window.append((batch, pending, addr, time.monotonic()))

    def _ack_actor_tasks(self, actor_hex: str, n: int):
        with self._outbox_cv:
            left = self._actor_unacked.get(actor_hex, 0) - n
            if left > 0:
                self._actor_unacked[actor_hex] = left
            else:
                self._actor_unacked.pop(actor_hex, None)
            self._outbox_cv.notify_all()

    def _drain_actor_window(self, actor_hex: str):
        """Flusher duty: pop completed batch frames off the window head;
        on failure, resend the failed batch AND everything after it in
        order (they shared the dead socket / stale incarnation). Never
        blocks on an unready head — a stalled frame is failed only past
        its 60s deadline so one wedged actor cannot stall the flusher."""
        window = self._actor_windows.get(actor_hex)
        while window:
            tasks, pending, addr, sent_at = window[0]
            if not pending._ev_reply[0].is_set():
                if time.monotonic() - sent_at < 60.0:
                    return
                err: BaseException = TimeoutError(
                    f"actor submit unacked for 60s ({actor_hex[:8]})")
            else:
                err = None
                try:
                    pending.result(timeout=0)
                except (exc.ActorDiedError, exc.ActorUnavailableError,
                        OSError, ConnectionLost, TimeoutError,
                        LookupError) as e:
                    err = e
            window.popleft()
            self._ack_actor_tasks(actor_hex, len(tasks))
            if err is None:
                self._record_acked_tasks(actor_hex, tasks)
            if err is not None:
                failed = [(t, addr) for t in tasks]
                while window:
                    ts, _, a, _ = window.popleft()
                    failed += [(t, a) for t in ts]
                    self._ack_actor_tasks(actor_hex, len(ts))
                for t, a in failed:
                    self._resend_actor_task(t, actor_hex, err, a)
                return

    def _resend_actor_task(self, task: dict, actor_hex: str,
                           first_err: BaseException, addr_used):
        """Retry with a refreshed location under a bounded redial window
        (reference: client resend protocol on actor restart). A single
        shot here condemned LIVE actors during transient partitions of
        the owner link: the retry dial failed inside the same cut and
        the task came back ActorDiedError even though the actor process
        never died. Transport errors now drop the cached client, back
        off (config ``rpc_backoff_*``), and redial until
        ``rpc_redial_window_s`` closes; an ActorDiedError /
        ActorUnavailableError from the GCS is authoritative and stops
        the loop at once. Seq handling: same incarnation keeps the
        ORIGINAL seq (the actor never consumed it; duplicates dedup
        worker-side), a new incarnation renumbers from the reset counter
        — either way no gap stalls the actor's ordered queue."""
        if self._closed:
            return  # store may be unmapped mid-shutdown: never touch
        if isinstance(first_err, (OSError, ConnectionLost)) \
                and addr_used is not None:
            # transport failure ON THE RAYLET LINK: reconnect on retry.
            # App-level errors keep the healthy shared connection.
            try:
                self._drop_actor_client(addr_used)
            except Exception:  # noqa: BLE001
                pass
        self._actor_locations.pop(actor_hex, None)
        from ray_tpu_torch.utils.config import get_config as _gc
        cfg = _gc()
        deadline = time.monotonic() + cfg.rpc_redial_window_s
        attempt = 0
        err: BaseException = first_err
        while True:
            attempt += 1
            addr = None
            try:
                addr, incarnation = self._actor_location(actor_hex)
                if incarnation != task.get("incarnation"):
                    with self._seq_lock:
                        seq = self._actor_seq.get(actor_hex, 0)
                        self._actor_seq[actor_hex] = seq + 1
                    task["seq"] = seq
                    task["incarnation"] = incarnation
                client = self._actor_client(addr)
                client.call("submit_actor_task", task=task, timeout=30)
                self._record_acked_tasks(actor_hex, (task,))
                return
            except (exc.ActorDiedError, exc.ActorUnavailableError) as e:
                err = e      # GCS verdict: no amount of redialing helps
                break
            except (OSError, ConnectionLost, LookupError,
                    TimeoutError) as e:
                err = e
                if addr is not None:
                    try:
                        self._drop_actor_client(addr)
                    except Exception:  # noqa: BLE001
                        pass
                self._actor_locations.pop(actor_hex, None)
                import random as _random
                delay = min(cfg.rpc_backoff_max_s,
                            cfg.rpc_backoff_initial_s
                            * cfg.rpc_backoff_multiplier ** (attempt - 1))
                if cfg.rpc_backoff_jitter:
                    delay *= 1.0 + cfg.rpc_backoff_jitter * (
                        2.0 * _random.random() - 1.0)
                if time.monotonic() + delay >= deadline or self._closed:
                    break
                time.sleep(delay)
        err = err if isinstance(err, exc.RayTpuError) else \
            exc.ActorDiedError(actor_hex, repr(err),
                               restart_count=task.get("incarnation", 0))
        if task.get("pinned"):
            self._refs.release_task_pin(task.get("task_id", ""))
        for oid_hex in task.get("return_oids", ()):
            oid = bytes.fromhex(oid_hex)
            if not self.store.contains(oid):
                try:
                    object_codec.put_value(self.store, oid, err,
                                           is_error=True)
                except Exception:  # noqa: BLE001
                    pass
        # The consumed seq would leave a GAP the actor's ordered queue
        # waits on forever (stalling every later call). Queue a noop
        # gap-filler: the reaper keeps sending it until it lands or the
        # actor moves to a new incarnation (which resets numbering).
        # (No "seq" in the task means the failure hit BEFORE numbering —
        # nothing was consumed, no gap exists.)
        if not task.get("noop") and "seq" in task:
            filler = {"actor_id": actor_hex, "caller_id": self.caller_id,
                      "task_id": task.get("task_id", ""),
                      "method_name": "", "args_blob": b"",
                      "return_oids": [], "noop": True,
                      "seq": task["seq"],
                      "incarnation": task.get("incarnation", 0)}
            with self._seq_lock:
                self._actor_gap_fillers.setdefault(actor_hex,
                                                   []).append(filler)
            self._ensure_actor_reaper()

    def _flush_gap_fillers(self):
        """Reaper duty: deliver queued seq gap-fillers; drop them once
        the actor reached a new incarnation (fresh numbering, no gap)."""
        with self._seq_lock:
            items = [(a, list(fs)) for a, fs in
                     self._actor_gap_fillers.items() if fs]
        for actor_hex, fillers in items:
            for filler in fillers:
                delivered = False
                try:
                    addr, incarnation = self._actor_location(actor_hex)
                    if incarnation != filler["incarnation"]:
                        delivered = True   # numbering reset: gap is moot
                    else:
                        self._actor_client(addr).call(
                            "submit_actor_task", task=filler, timeout=10)
                        delivered = True
                except (exc.ActorDiedError, exc.ActorUnavailableError):
                    delivered = True       # actor gone: nobody waits
                except Exception:  # noqa: BLE001 - retry next tick
                    pass
                if delivered:
                    with self._seq_lock:
                        fs = self._actor_gap_fillers.get(actor_hex, [])
                        if filler in fs:
                            fs.remove(filler)

    def _record_acked_tasks(self, actor_hex: str, tasks):
        """Track acked-but-unresolved calls for the dead-actor sweep.
        Once the worker acks a submit, the submit plane (window +
        resend) is done with the task — but its return oids are only as
        durable as the worker's queue. Entries leave via the sweep:
        pruned when their oids land, failed typed when the actor dies."""
        with self._inflight_lock:
            per = self._actor_inflight.setdefault(actor_hex, {})
            for t in tasks:
                if t.get("noop") or not t.get("return_oids"):
                    continue
                per[t["task_id"]] = (tuple(t["return_oids"]),
                                     t.get("incarnation", 0),
                                     bool(t.get("pinned")))
            if not per:
                self._actor_inflight.pop(actor_hex, None)

    def _sweep_dead_actor_calls(self):
        """Reaper duty: fail calls that died INSIDE a dead actor's
        queue. A crash-killed worker takes its accepted-but-unfinished
        queue down with it; nothing on the submit plane retries those
        (they were acked), so without this sweep their return oids are
        never written and an untimed get() wedges forever. The pushed
        actor table (CH_ACTOR) is the authority: state DEAD — or an
        ALIVE entry whose incarnation has advanced past the one that
        accepted the call — means the accepting queue is gone, and the
        unresolved oids get a typed ActorDiedError."""
        with self._inflight_lock:
            snapshot = [(a, dict(per))
                        for a, per in self._actor_inflight.items()]
        for actor_hex, per in snapshot:
            resolved = [tid for tid, (oids, _, _p) in per.items()
                        if all(self.store.contains(bytes.fromhex(o))
                               for o in oids)]
            if resolved:
                with self._inflight_lock:
                    live = self._actor_inflight.get(actor_hex)
                    if live:
                        for tid in resolved:
                            live.pop(tid, None)
                            per.pop(tid, None)
                        if not live:
                            self._actor_inflight.pop(actor_hex, None)
            if not per:
                continue
            with self._actor_table_cv:
                ent = self._actor_table.get(actor_hex)
            reg_err = self._reg_failed.get(actor_hex)
            if ent is None and reg_err is None:
                continue
            if reg_err is not None:
                dead = {tid: exc.ActorDiedError(actor_hex, reg_err)
                        for tid in per}
            elif ent["state"] == "DEAD":
                restarts = ent.get("num_restarts", 0)
                dead = {tid: exc.ActorDiedError(
                            actor_hex, ent.get("death_reason", "dead"),
                            restart_count=restarts)
                        for tid in per}
            else:
                # ALIVE but restarted: calls acked into an OLDER
                # incarnation died with it (the fresh process has an
                # empty queue and will never see them)
                restarts = ent.get("num_restarts", 0)
                dead = {tid: exc.ActorDiedError(
                            actor_hex,
                            f"actor restarted; incarnation {inc} died "
                            f"holding this call",
                            restart_count=restarts)
                        for tid, (_, inc, _p) in per.items()
                        if inc < restarts}
            if not dead:
                continue
            for tid, err in dead.items():
                oids, _inc, pinned = per[tid]
                for oid_hex in oids:
                    oid = bytes.fromhex(oid_hex)
                    if not self.store.contains(oid):
                        try:
                            object_codec.put_value(self.store, oid, err,
                                                   is_error=True)
                        except Exception:  # noqa: BLE001
                            pass
                if pinned:
                    try:
                        self._refs.release_task_pin(tid)
                    except Exception:  # noqa: BLE001
                        pass
            with self._inflight_lock:
                live = self._actor_inflight.get(actor_hex)
                if live:
                    for tid in dead:
                        live.pop(tid, None)
                    if not live:
                        self._actor_inflight.pop(actor_hex, None)

    def _ensure_actor_reaper(self):
        """Start the actor submit flusher: the single thread that sends
        outbox batches, drains reply windows (surfacing failures of the
        LAST submits in a burst even when no further call touches the
        actor), and delivers seq gap-fillers."""
        if self._actor_reaper_started:
            return
        with self._seq_lock:
            if self._actor_reaper_started:
                return
            self._actor_reaper_started = True

        def loop():
            gap_tick = 0.0
            sweep_tick = 0.0
            while not self._closed:
                linger = False
                with self._outbox_cv:
                    if not self._actor_outbox:
                        # frames in flight need a tight drain cadence (acks
                        # feed the flow-control window); fully idle can
                        # sleep longer — a new submit notifies the cv
                        busy = any(self._actor_windows.values())
                        self._outbox_cv.wait(timeout=0.002 if busy else 0.05)
                    else:
                        linger = any(self._actor_windows.values())
                if linger:
                    # mid-burst micro-linger: when the flusher keeps pace
                    # with the submitter, batches collapse to size 1 and
                    # throughput falls back to per-call framing. 200us of
                    # accumulation is hidden behind the frame already in
                    # flight; isolated single calls (no in-flight frames)
                    # skip it entirely.
                    time.sleep(0.0002)
                try:
                    self._flush_actor_outbox()
                except Exception:  # noqa: BLE001
                    pass
                for actor_hex in list(self._actor_windows):
                    try:
                        self._drain_actor_window(actor_hex)
                    except Exception:  # noqa: BLE001
                        pass
                now = time.monotonic()
                if now - gap_tick >= 0.05:
                    gap_tick = now
                    try:
                        self._flush_gap_fillers()
                    except Exception:  # noqa: BLE001
                        pass
                if now - sweep_tick >= 0.5:
                    sweep_tick = now
                    try:
                        self._sweep_dead_actor_calls()
                    except Exception:  # noqa: BLE001
                        pass

        self._actor_reaper = threading.Thread(
            target=loop, daemon=True, name="actor-submit-flusher")
        self._actor_reaper.start()

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        # a kill racing the registration coalescer would find no actor
        # at the GCS and silently no-op — drain this id's frame first
        self._reg_drain(actor_id.hex())
        self._gcs.call("kill_actor", actor_id=actor_id.hex(),
                       no_restart=no_restart)
        entry = self._actor_locations.pop(actor_id.hex(), None)
        if entry is not None:
            # retire the dead incarnation's cached push-port client
            self._drop_actor_client(entry[0])

    def get_actor(self, name: str, namespace: str | None = None) -> ActorID:
        info = self._gcs.call("get_actor", name=name,
                              namespace=self._effective_namespace(namespace))
        if info is None:
            raise ValueError(f"Failed to look up actor with name {name!r}")
        return ActorID.from_hex(info["actor_id"])

    def actor_state(self, actor_id: ActorID):
        return None  # class name not tracked cluster-side (handle shows id)

    # ------------------------------------------------------------------
    # cluster info / lifecycle
    # ------------------------------------------------------------------

    def cluster_resources(self) -> dict:
        return self._gcs.call("cluster_resources")["total"]

    def available_resources_snapshot(self) -> dict:
        return self._gcs.call("cluster_resources")["available"]

    def shutdown(self):
        if self._owns_flusher:
            # clean exit = immediate owner-death semantics: the GCS
            # drops this client's holds and reaps its non-detached
            # actors (reference: driver exit, gcs_actor_manager.cc:632)
            try:
                self._gcs.call("unregister_client",
                               client_id=self.client_id)
            except Exception:  # noqa: BLE001 - timeout reaping covers it
                pass
            from ray_tpu_torch.runtime import refcount as _refcount
            _refcount.release_flusher(self.client_id)
            self._refs.reset()
        if self._use_memstore:
            # reset() clears hooks wholesale for the flusher owner; a
            # nested runtime must unhook only its own
            self._refs.remove_release_hook(self._memstore_release_hook)
            self._refs.remove_serialize_hook(self._memstore_serialize_hook)
            self._memstore.clear()
        self._closed = True
        with self._reg_cv:
            self._reg_cv.notify_all()   # reg flusher drains + exits
        # the submit flusher reads the store (its dead-actor sweep): it
        # ends its pass before the store unmaps below
        with self._outbox_cv:
            self._outbox_cv.notify_all()
        reaper = self._actor_reaper
        if reaper is not None and reaper is not threading.current_thread():
            reaper.join(timeout=5.0)
        if self._actor_sub is not None:
            try:
                self._actor_sub.close()
            except Exception:  # noqa: BLE001
                pass
        self._leases.stop()
        # grace for pusher threads already past their _closed checks to
        # finish touching the store before it unmaps
        time.sleep(0.05)
        with self._actor_clients_lock:
            clients = list(self._actor_clients.values())
            self._actor_clients.clear()
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        try:
            self._gcs.close()
            self._raylet.close()
            self.store.close()
        except Exception:  # noqa: BLE001
            pass


def _wire_strategy(spec: TaskSpec) -> dict:
    s = spec.scheduling_strategy
    out = {"kind": s.kind}
    if s.node_id is not None:
        out["node_id"] = s.node_id if isinstance(s.node_id, str) \
            else s.node_id.hex()
    return out


def _dumps_or_type_error(value, name: str, what: str) -> bytes:
    """``value`` as the port's pickle bytes; ``TypeError`` when pickle
    cannot carry it to a worker process."""
    import pickle

    try:
        return serialization.dumps(value)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"{what} of {name!r} cannot reach a worker process by pickle: "
            "define functions and classes at module level (the port "
            f"carries them by stdlib pickle, not cloudpickle) ({e})") from e
