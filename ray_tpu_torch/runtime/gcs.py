"""GCS: the cluster control plane (head-node service).

Reference analog: ``src/ray/gcs/gcs_server/`` — node registry + health
(``GcsNodeManager``, ``GcsHealthCheckManager`` gcs_health_check_manager.h:39),
actor registry and scheduling (``GcsActorManager`` gcs_actor_manager.cc:246,
632, restart logic :1100), KV store (``GcsKvManager``), object directory
(owner-based in the reference; centralized here), pubsub
(``gcs_server/pubsub_handler.cc``), placement groups
(``GcsPlacementGroupManager`` — 2-phase reserve/commit), and the cluster
resource view (``GcsResourceManager`` fed by the ray_syncer).

One process/thread, guarded by a single lock — the control plane is
low-rate; the data plane (objects) never flows through here.

Port of ``ray_tpu/runtime/gcs.py`` with the node, actor, placement-group,
job, KV and object-directory tables, the reference counts and
``GcsPersistence``. The observability planes' stores (``LogStore``,
``MetricsStore``, ``TraceStore``) and the profiling RPCs are a later
slice: an RPC that only they serve answers ``NotImplementedError``. The
fault-injection plane's crash point ``gcs.after_wal_append`` and its plan
switch key (``kv_put`` of ``__fault_injection__``/``plan``) are as in
JAX. Resource-driven node picks use the
port's build of the native hybrid policy (``_private/scheduling.py``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.runtime import fault_injection as _fi
from ray_tpu_torch.runtime.rpc import RpcServer, send_msg

# Pubsub channels (reference: pubsub.proto:28 channel enum).
CH_NODE = "node"            # node added/dead
CH_ACTOR = "actor"          # actor state transitions
CH_OBJECT = "object"        # object location added (get() wakeups)
CH_ERROR = "error"          # error broadcast to drivers


@dataclass
class NodeInfo:
    node_id: str
    address: tuple          # raylet RPC address
    store_name: str         # shm segment name (same-host attach fast path)
    resources: dict         # total
    available: dict
    labels: dict = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    # versioned resource view (reference: ray_syncer.h:86) — the last
    # applied RESOURCE_VIEW version; -1 = never synced (ask the raylet
    # for a full push on its next heartbeat)
    resource_version: int = -1
    # ready-queue depth from the versioned view (placement tiebreak)
    load: int = 0
    # latest reporter sample from the node (cpu/mem/spill-disk)
    host_stats: dict = field(default_factory=dict)


@dataclass
class ActorInfo:
    actor_id: str
    name: str | None
    state: str              # PENDING | ALIVE | RESTARTING | DEAD
    # logical namespace scoping the name (reference: worker.py:1157 —
    # named actors are unique PER NAMESPACE, not cluster-global)
    namespace: str = "default"
    # owner-scoped lifetime (reference: gcs_actor_manager.cc:632 — a
    # non-detached actor dies with its owner; lifetime="detached" opts
    # out, actor.py:524). owner_id is the creating client; None (e.g.
    # external-language clients) means detached.
    owner_id: str | None = None
    detached: bool = True
    node_id: str | None = None
    creation_spec: bytes | None = None   # pickled wire spec (for restart)
    resources: dict = field(default_factory=dict)
    max_restarts: int = 0
    num_restarts: int = 0
    death_reason: str = ""
    # placement constraint recorded so restart honors it
    pg_id: str | None = None
    # the live worker's owner-facing push port (direct actor submission);
    # None until ready, reset on restart (stale addrs must not be dialed)
    push_addr: tuple | None = None


@dataclass
class PlacementGroupInfo:
    pg_id: str
    strategy: str                       # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    bundles: list                       # list[dict resource -> amount]
    state: str = "PENDING"              # PENDING | CREATED | REMOVED
    bundle_nodes: list = field(default_factory=list)  # node_id per bundle


class GcsPersistence:
    """File-backed store client (reference: ``StoreClient`` behind the
    GCS — ``store_client/redis_store_client.h:33`` — plus restart reload
    via ``gcs_init_data.cc``; Redis is not in this image, so the durable
    medium is the session directory).

    Layout: ``snapshot.pkl`` (periodic full-state dump, atomic rename)
    + ``wal.bin`` (length-prefixed pickled mutation records appended
    between snapshots and truncated by each snapshot). Restart = load
    snapshot, replay WAL."""

    def __init__(self, path: str):
        import os

        os.makedirs(path, exist_ok=True)
        self.snap_path = os.path.join(path, "snapshot.pkl")
        self.wal_path = os.path.join(path, "wal.bin")
        self._wal_f = None
        self._io_lock = threading.Lock()

    def append(self, record: tuple):
        import pickle
        import struct

        blob = pickle.dumps(record, protocol=5)
        with self._io_lock:
            if self._wal_f is None:
                self._wal_f = open(self.wal_path, "ab")
            self._wal_f.write(struct.pack(">I", len(blob)) + blob)
            self._wal_f.flush()

    def rotate_wal(self):
        """Move the live WAL aside (cheap, lock-held by the caller along
        with the state capture). Records in the rotated file stay
        replayable until ``commit_snapshot`` lands the state that
        contains them — a crash in between loses nothing."""
        import os

        with self._io_lock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None
            if os.path.exists(self.wal_path):
                os.replace(self.wal_path, self.wal_path + ".rotated")

    def commit_snapshot(self, state: dict):
        """Write the snapshot (slow disk IO — caller holds NO state lock)
        and retire the rotated WAL it supersedes."""
        import os
        import pickle

        with self._io_lock:
            tmp = self.snap_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(state, f, protocol=5)
            os.replace(tmp, self.snap_path)
            try:
                os.remove(self.wal_path + ".rotated")
            except OSError:
                pass

    def snapshot(self, state: dict):
        """Atomic capture-and-fold (small states / shutdown path)."""
        self.rotate_wal()
        self.commit_snapshot(state)

    def load(self) -> tuple[dict | None, list]:
        import os
        import pickle
        import struct

        state = None
        if os.path.exists(self.snap_path):
            try:
                with open(self.snap_path, "rb") as f:
                    state = pickle.load(f)
            except Exception:  # noqa: BLE001 - torn snapshot: WAL only
                state = None
        records = []
        # a .rotated WAL outlives a crash between rotation and snapshot
        # commit — replay it FIRST (its records predate the live WAL's)
        for path in (self.wal_path + ".rotated", self.wal_path):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "rb") as f:
                    data = f.read()
                off = 0
                while off + 4 <= len(data):
                    (n,) = struct.unpack_from(">I", data, off)
                    off += 4
                    if off + n > len(data):
                        break   # torn tail record (crash mid-append)
                    records.append(pickle.loads(data[off:off + n]))
                    off += n
            except Exception:  # noqa: BLE001
                pass
        return state, records

    def close(self):
        with self._io_lock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None


class GcsServer(RpcServer):
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: float = 5.0,
                 persistence_dir: str | None = None):
        super().__init__(host, port)
        self.fault_label = "gcs"   # fault-injection endpoint label
        _fi.maybe_init_from_config()
        self._lock = threading.RLock()
        self._nodes: dict[str, NodeInfo] = {}
        self._actors: dict[str, ActorInfo] = {}
        self._named_actors: dict[str, str] = {}
        self._kv: dict[str, dict[str, bytes]] = {}
        self._object_dir: dict[str, set[str]] = {}   # oid -> node ids
        self._object_meta: dict[str, int] = {}       # oid -> size (for ref)
        # objects whose LAST location died (known-then-lost tombstones):
        # distinguishes "task hasn't produced it yet" from "needs lineage
        # reconstruction" for owners (reference: the owner learns loss via
        # object-eviction pubsub + ObjectDirectory). Bounded: a dict in
        # insertion order, oldest dropped past the cap — a tombstone only
        # matters while some owner still wants the object.
        self._lost_objects: dict[str, None] = {}
        self._max_lost_objects = 100_000
        self._pgs: dict[str, PlacementGroupInfo] = {}
        self._jobs: dict[str, dict] = {}
        # cached host_actors channels, one per raylet (see _place_batch)
        self._placement_clients: dict[tuple, Any] = {}
        self._placement_lock = threading.Lock()
        # Bounded placement executor (reference: GcsActorScheduler's
        # shared io_context — NOT thread-per-actor): host_actors batches
        # queue here; at most gcs_placement_pool_size workers drain it.
        from ray_tpu_torch.utils.config import get_config as _gcfg
        _pcfg = _gcfg()
        self._place_pool_size = max(1, _pcfg.gcs_placement_pool_size)
        self._place_batch_cap = max(1, _pcfg.gcs_placement_batch_size)
        self._place_queue: deque = deque()
        self._place_cv = threading.Condition()
        self._place_threads: list[threading.Thread] = []
        # pubsub: channel -> list of (conn, send_lock)
        self._subs: dict[str, list] = {}
        # CH_ACTOR per-subscriber coalescing: actor events buffer per
        # held conn and a flusher ships ONE framed batch per subscriber
        # per window — rpc_actor_ready no longer pays an inline send_msg
        # per actor per subscriber under a creation flood.
        self._pub_flush_s = _pcfg.actor_pubsub_flush_s
        self._pub_buf: dict[int, tuple] = {}   # id(conn) -> (conn, lock, [msgs])
        self._pub_cv = threading.Condition()
        # creation-phase decomposition (register -> place -> ready),
        # cumulative; actor_id -> (t_register, t_placed) while in flight
        self._plane = {
            "register_batches": 0, "register_actors": 0,
            "register_batch_max": 0, "host_batches": 0, "host_actors": 0,
            "host_batch_max": 0, "ready_batches": 0, "ready_actors": 0,
            "place_s": 0.0, "placed": 0, "ready_s": 0.0, "ready": 0,
        }
        self._plane_t: dict[str, list] = {}
        self._hb_timeout = heartbeat_timeout_s
        # --- distributed refcounting (reference: reference_count.h:61;
        # centralized here to match the centralized object directory).
        # count(oid) = holders + task pins + contains edges; a decrement
        # to zero releases every registered copy cluster-wide. ---
        from ray_tpu_torch.utils.config import get_config as _get_config
        _cfg = _get_config()
        self._client_timeout = _cfg.client_timeout_s
        self._ref_grace = _cfg.ref_release_grace_s
        self._clients: dict[str, dict] = {}        # id -> kind/last_seen/alive
        self._ref_holders: dict[str, set] = {}     # oid -> holder client ids
        self._ref_pins: dict[str, tuple] = {}      # task_id -> (client, oids)
        self._ref_pin_count: dict[str, int] = {}   # oid -> pin contributions
        self._pin_released: dict[str, None] = {}   # early-release tombstones
        self._ref_contains: dict[str, list] = {}   # outer oid -> inner oids
        self._ref_contained: dict[str, int] = {}   # inner oid -> edge count
        self._ref_released: dict[str, None] = {}   # freed oids (tombstones)
        self._pending_release: dict[str, set] = {} # node -> oids to free
        self._deferred_contains: list = []         # (due, [inner oids])
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True)
        self._task_events: list[dict] = []           # bounded task event sink
        self._pending_demand: dict[str, list] = {}   # node -> unmet demands
        self._max_task_events = 10000
        # --- persistence (GCS fault tolerance) ---
        self._persist = (GcsPersistence(persistence_dir)
                         if persistence_dir else None)
        self._dirty = False
        if self._persist is not None:
            self._restore()

    # ------------------------------------------------------------------
    # persistence (reference: StoreClient-backed tables + GcsInitData
    # restart reload; critical mutations WAL'd, full state snapshotted)
    # ------------------------------------------------------------------

    def _log(self, kind: str, key, payload):
        """WAL one mutation (entity upsert/delete, last-writer-wins on
        replay). No-op without persistence."""
        persist = self._persist   # None once closed without a snapshot
        if persist is None:
            return
        try:
            persist.append((kind, key, payload))
        except (OSError, ValueError):
            pass
        self._dirty = True

    def _state_dict(self) -> dict:
        from dataclasses import asdict

        with self._lock:
            return {
                "actors": {k: asdict(a) for k, a in self._actors.items()},
                "named_actors": dict(self._named_actors),
                "kv": {ns: dict(kv) for ns, kv in self._kv.items()},
                "pgs": {k: asdict(p) for k, p in self._pgs.items()},
                "jobs": {k: dict(j) for k, j in self._jobs.items()},
                "object_dir": {o: sorted(ls)
                               for o, ls in self._object_dir.items()},
                "object_meta": dict(self._object_meta),
                "lost_objects": list(self._lost_objects),
                # refcount state rides the snapshot (not the WAL — the
                # mutation rate is too high); a crash loses at most one
                # snapshot period of deltas
                "ref": {
                    "clients": {cid: c["kind"]
                                for cid, c in self._clients.items()
                                if c["alive"]},
                    "holders": {o: sorted(hs)
                                for o, hs in self._ref_holders.items()},
                    "pins": {t: (c, list(os_))
                             for t, (c, os_) in self._ref_pins.items()},
                    "contains": {o: list(i)
                                 for o, i in self._ref_contains.items()},
                    "released": list(self._ref_released),
                    "pending_release": {n: sorted(s) for n, s in
                                        self._pending_release.items()},
                },
            }

    def _apply_record(self, kind: str, key, payload):
        if kind == "actor":
            if payload is None:
                self._actors.pop(key, None)
            else:
                self._actors[key] = ActorInfo(**payload)
        elif kind == "actors":
            # one record per registration/ready BATCH (the batched plane
            # appends one WAL record for N actors, not N records)
            for actor in payload.get("actors", ()):
                self._actors[actor["actor_id"]] = ActorInfo(**actor)
            for nkey, aid in payload.get("named", {}).items():
                self._named_actors[nkey] = aid
        elif kind == "named":
            if payload is None:
                self._named_actors.pop(key, None)
            else:
                self._named_actors[key] = payload
        elif kind == "kv":
            ns, k = key
            if payload is None:
                self._kv.get(ns, {}).pop(k, None)
            else:
                self._kv.setdefault(ns, {})[k] = payload
        elif kind == "pg":
            if payload is None:
                self._pgs.pop(key, None)
            else:
                self._pgs[key] = PlacementGroupInfo(**payload)
        elif kind == "job":
            self._jobs[key] = payload

    def _restore(self):
        """Reload snapshot + WAL; nodes are NOT restored — live raylets
        re-register within one heartbeat (their reconnecting clients get
        ``reregister`` on the first post-restart heartbeat), and their
        location reconciliation re-populates dead entries' truth."""
        state, records = self._persist.load()
        if state:
            self._actors = {k: ActorInfo(**v)
                            for k, v in state["actors"].items()}
            self._named_actors = dict(state["named_actors"])
            self._kv = {ns: dict(kv) for ns, kv in state["kv"].items()}
            self._pgs = {k: PlacementGroupInfo(**v)
                         for k, v in state["pgs"].items()}
            self._jobs = dict(state["jobs"])
            self._object_dir = {o: set(ls)
                                for o, ls in state["object_dir"].items()}
            self._object_meta = dict(state["object_meta"])
            self._lost_objects = dict.fromkeys(state["lost_objects"])
            ref = state.get("ref")
            if ref:
                # client last_seen is process-local monotonic time:
                # reset to "now" so live clients get a full timeout
                # window to resume heartbeating after the restart
                now = time.monotonic()
                self._clients = {cid: {"kind": k, "last_seen": now,
                                       "alive": True}
                                 for cid, k in ref["clients"].items()}
                self._ref_holders = {o: set(hs)
                                     for o, hs in ref["holders"].items()}
                self._ref_pins = {t: (c, list(os_))
                                  for t, (c, os_) in ref["pins"].items()}
                self._ref_pin_count = {}
                for _, (_, os_) in self._ref_pins.items():
                    for o in os_:
                        self._ref_pin_count[o] = \
                            self._ref_pin_count.get(o, 0) + 1
                self._ref_contains = {o: list(i)
                                      for o, i in ref["contains"].items()}
                self._ref_contained = {}
                for inners in self._ref_contains.values():
                    for o in inners:
                        self._ref_contained[o] = \
                            self._ref_contained.get(o, 0) + 1
                self._ref_released = dict.fromkeys(ref["released"])
                self._pending_release = {n: set(s) for n, s in
                                         ref["pending_release"].items()}
        for kind, key, payload in records:
            try:
                self._apply_record(kind, key, payload)
            except Exception:  # noqa: BLE001 - skip torn/stale records
                pass

    def _snapshot_loop(self):
        while not self._stopping:
            time.sleep(2.0)
            persist = self._persist   # None once closed without a snapshot
            if self._dirty and persist is not None:
                self._dirty = False
                try:
                    # capture + WAL rotation under the GCS lock (cheap —
                    # no record can land between them and be discarded);
                    # the snapshot's DISK write runs outside the lock so
                    # control-plane RPCs never stall behind file IO
                    with self._lock:
                        state = self._state_dict()
                        persist.rotate_wal()
                    persist.commit_snapshot(state)
                except OSError:
                    self._dirty = True

    def _log_actor(self, actor: "ActorInfo"):
        from dataclasses import asdict

        self._log("actor", actor.actor_id, asdict(actor))

    def _log_actors(self, actors: list, named: dict | None = None):
        """One WAL record per BATCH of actor upserts (the batched
        registration/ready paths must not pay one append+flush per
        actor)."""
        from dataclasses import asdict

        if not actors and not named:
            return
        if len(actors) == 1 and not named:
            self._log_actor(actors[0])
            return
        self._log("actors", None, {
            "actors": [asdict(a) for a in actors],
            "named": dict(named or {})})

    def _restore_reconcile(self):
        """Post-restart reconciliation (reference: GcsInitData load then
        reconcile against re-registering raylets): give live raylets one
        re-registration window, then (a) reschedule actors stuck in
        PENDING/RESTARTING (their placement RPC died with the old
        process) and (b) run the failure path for ALIVE actors whose
        node never came back."""
        deadline = time.monotonic() + max(self._hb_timeout, 2.0)
        while time.monotonic() < deadline and not self._stopping:
            with self._lock:
                if self._nodes:
                    break
            time.sleep(0.1)
        time.sleep(0.5)   # let the rest of the fleet re-register too
        if self._stopping:
            return
        with self._lock:
            stuck = [a.actor_id for a in self._actors.values()
                     if a.state in ("PENDING", "RESTARTING")]
            orphaned = [a for a in self._actors.values()
                        if a.state == "ALIVE" and (
                            a.node_id not in self._nodes
                            or not self._nodes[a.node_id].alive)]
        for actor_id in stuck:
            self._schedule_actor(actor_id)
        for actor in orphaned:
            self._on_actor_failure(
                actor, "node lost while the control plane was down")

    def start(self):
        super().start()
        self._health_thread.start()
        threading.Thread(target=self._pub_flush_loop, daemon=True,
                         name="gcs-pub-flusher").start()
        if self._persist is not None:
            threading.Thread(target=self._snapshot_loop,
                             daemon=True).start()
            with self._lock:
                needs_reconcile = bool(self._actors)
            if needs_reconcile:
                threading.Thread(target=self._restore_reconcile,
                                 daemon=True).start()
        return self

    def stop(self):
        super().stop()
        with self._place_cv:
            self._place_cv.notify_all()   # placement workers exit
        with self._pub_cv:
            self._pub_cv.notify_all()     # pub flusher exits
        with self._placement_lock:
            clients, self._placement_clients = \
                dict(self._placement_clients), {}
        for client in clients.values():
            try:
                client.close()
            except OSError:
                pass
        if self._persist is not None:
            try:
                self._persist.snapshot(self._state_dict())
            except OSError:
                pass
            self._persist.close()

    # ------------------------------------------------------------------
    # pubsub (reference: src/ray/pubsub/ publisher.h)
    # ------------------------------------------------------------------

    def rpc_subscribe(self, conn, send_lock, *, channels: list):
        with self._lock:
            for ch in channels:
                subs = self._subs.setdefault(ch, [])
                # dedupe per (conn, channel): a re-subscribe after a
                # redial races the old entry's cleanup on the SAME held
                # conn — appending unconditionally double-delivered
                # every message to that subscriber
                if not any(c is conn for c, _ in subs):
                    subs.append((conn, send_lock))
        send_msg(conn, {"subscribed": channels}, send_lock)
        return RpcServer.HELD

    def publish(self, channel: str, message: dict):
        message = {"channel": channel, **message}
        with self._lock:
            subs = list(self._subs.get(channel, []))
        if not subs:
            return
        if channel == CH_ACTOR and self._pub_flush_s > 0:
            # coalesce: buffer per (subscriber, channel), flusher ships
            # one framed batch per window — the publisher (often
            # rpc_actor_ready under the creation flood) never blocks on
            # N sockets
            with self._pub_cv:
                for conn, send_lock in subs:
                    ent = self._pub_buf.get((id(conn), channel))
                    if ent is None:
                        self._pub_buf[(id(conn), channel)] = (
                            conn, send_lock, channel, [message])
                    else:
                        ent[3].append(message)
                self._pub_cv.notify_all()
            return
        self._send_to_subs([(conn, lk, message) for conn, lk in subs])

    def _pub_flush_loop(self):
        while not self._stopping:
            with self._pub_cv:
                while not self._pub_buf and not self._stopping:
                    self._pub_cv.wait(0.5)
                if self._stopping:
                    return
            time.sleep(self._pub_flush_s)   # coalesce the burst
            with self._pub_cv:
                buf, self._pub_buf = self._pub_buf, {}
            sends = []
            for conn, send_lock, channel, msgs in buf.values():
                if len(msgs) == 1:
                    sends.append((conn, send_lock, msgs[0]))
                else:
                    sends.append((conn, send_lock,
                                  {"channel": channel, "batch": msgs}))
            self._send_to_subs(sends)

    def _send_to_subs(self, sends: list):
        """Deliver one message per (conn, send_lock, message) triple;
        dead conns are stripped from every channel and released."""
        dead = []
        for conn, send_lock, message in sends:
            try:
                send_msg(conn, message, send_lock)
            except OSError:
                dead.append((conn, send_lock))
        if dead:
            with self._lock:
                # strip dead conns from EVERY channel (multi-channel
                # subscribers leave stale entries otherwise)
                for subs in self._subs.values():
                    for item in dead:
                        try:
                            subs.remove(item)
                        except ValueError:
                            pass
            for conn, _ in dead:
                self.release_conn(conn)   # held channel finished

    # ------------------------------------------------------------------
    # nodes + health (reference: GcsNodeManager / GcsHealthCheckManager)
    # ------------------------------------------------------------------

    def rpc_register_node(self, conn, send_lock, *, node_id, address,
                          store_name, resources, labels=None):
        with self._lock:
            self._nodes[node_id] = NodeInfo(
                node_id=node_id, address=tuple(address),
                store_name=store_name, resources=dict(resources),
                available=dict(resources), labels=labels or {},
            )
        self.publish(CH_NODE, {"event": "added", "node_id": node_id,
                               "address": tuple(address)})
        return {"ok": True}

    def rpc_resource_update(self, conn, send_lock, *, node_id, version,
                            available, load=0):
        """Versioned RESOURCE_VIEW push (reference: ray_syncer.cc:325
        BroadcastRaySyncMessage): applied only when newer than the
        stored version, so a slow push can never roll back a fresher
        view. This — not the heartbeat — is how the scheduling view
        tracks node state, at RPC latency. ``load`` = ready-queue depth
        (placement prefers shallow queues when every node is busy)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return {"ok": False, "reregister": True}
            if version > node.resource_version:
                node.resource_version = version
                node.available = dict(available)
                node.load = int(load)
        return {"ok": True}

    def rpc_heartbeat(self, conn, send_lock, *, node_id, available=None,
                      load=None, host_stats=None, freed_acks=None,
                      resource_version=None):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return {"ok": False, "reregister": True}
            node.last_heartbeat = time.monotonic()
            # liveness beat carries only the VERSION (payload O(1));
            # `available` still accepted for legacy/snapshot callers.
            # A version mismatch means the event-driven push stream and
            # this view diverged (lost push, GCS restart): ask for one
            # full resync push.
            need_resources = False
            if available is not None:
                node.available = dict(available)
                if resource_version is not None:
                    node.resource_version = resource_version
            elif resource_version is not None and \
                    node.resource_version < resource_version:
                # the raylet DELIVERED a version we never applied (GCS
                # restart / lost state): ask for a full resync. The
                # one-sided check matters: applied-ahead-of-acked is the
                # normal in-flight-ack case, not a loss.
                need_resources = True
            if host_stats:
                node.host_stats = dict(host_stats)
            # refcount release delivery is piggybacked on the heartbeat:
            # at-least-once (re-sent until the node acks on its next
            # beat; release is idempotent on the raylet side)
            if freed_acks:
                pend = self._pending_release.get(node_id)
                if pend is not None:
                    pend.difference_update(freed_acks)
                    if not pend:
                        del self._pending_release[node_id]
            pend = self._pending_release.get(node_id)
            release = sorted(pend)[:5000] if pend else None
        reply = {"ok": True}
        if release:
            reply["release_oids"] = release
        if need_resources:
            reply["need_resources"] = True
        return reply

    def rpc_get_nodes(self, conn, send_lock, *, alive_only: bool = True):
        with self._lock:
            return [
                {"node_id": n.node_id, "address": n.address,
                 "store_name": n.store_name, "resources": n.resources,
                 "available": n.available, "alive": n.alive,
                 "labels": n.labels, "host_stats": n.host_stats}
                for n in self._nodes.values()
                if n.alive or not alive_only
            ]

    def rpc_drain_node(self, conn, send_lock, *, node_id):
        self._mark_node_dead(node_id, reason="drained")
        return {"ok": True}

    def _health_loop(self):
        while not self._stopping:
            time.sleep(self._hb_timeout / 4)
            now = time.monotonic()
            with self._lock:
                dead = [n.node_id for n in self._nodes.values()
                        if n.alive and now - n.last_heartbeat > self._hb_timeout]
            for node_id in dead:
                self._mark_node_dead(node_id, reason="heartbeat timeout")
            try:
                self._process_deferred_contains()
                self._reap_stale_clients()
            except Exception:  # noqa: BLE001 - next tick retries
                pass

    def _mark_node_dead(self, node_id: str, reason: str):
        with self._lock:
            # a dead node's parked demand must not drive the autoscaler
            # forever
            self._pending_demand.pop(node_id, None)
            self._pending_release.pop(node_id, None)
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            # drop object locations on that node; tombstone objects whose
            # last copy just vanished so owners can trigger reconstruction
            for oid, locs in list(self._object_dir.items()):
                locs.discard(node_id)
                if not locs:
                    del self._object_dir[oid]
                    self._tombstone(oid, f"node_dead:{node_id[:8]}")
            doomed_actors = [a for a in self._actors.values()
                            if a.node_id == node_id
                            and a.state in ("ALIVE", "PENDING", "RESTARTING")]
        # retire the dead node's cached placement channel — raylet
        # restarts land on fresh ports, so entries left behind would
        # accumulate one dead client per retired address forever
        addr = tuple(node.address) if node.address else None
        if addr is not None:
            with self._placement_lock:
                stale = self._placement_clients.pop(addr, None)
            if stale is not None:
                try:
                    stale.close()
                except OSError:
                    pass
        self.publish(CH_NODE, {"event": "dead", "node_id": node_id,
                               "reason": reason})
        for actor in doomed_actors:
            self._on_actor_failure(actor, f"node {node_id} died: {reason}")

    # ------------------------------------------------------------------
    # actors (reference: GcsActorManager + GcsActorScheduler)
    # ------------------------------------------------------------------

    def _register_one_locked(self, *, actor_id, name, creation_spec,
                             resources, max_restarts, pg_id=None,
                             namespace=None, owner_id=None,
                             lifetime=None):
        """Per-actor registration core (caller holds self._lock; caller
        logs). Returns (result_dict, created: ActorInfo | None,
        named_key: str | None)."""
        namespace = namespace or "default"
        # owner-scoped lifetime (reference: actor.py:524 + gcs_actor_
        # manager.cc:632): default actors die with their owner client;
        # lifetime="detached" (or an ownerless registration) opts out
        detached = (lifetime == "detached") or owner_id is None
        # idempotent by actor_id: a retried registration (the reply
        # was lost to a partition, or the delivery was duplicated)
        # acks the registration that already exists instead of
        # rejecting its own name as taken
        existing = self._actors.get(actor_id)
        if existing is not None and existing.state != "DEAD":
            return ({"ok": True, "node_id": existing.node_id},
                    None, None)
        named_key = None
        if name is not None:
            key = _ns_key(namespace, name)
            if self._named_actors.get(key, actor_id) != actor_id:
                return ({"ok": False,
                         "error": f"Actor name {name!r} already taken "
                                  f"in namespace {namespace!r}"},
                        None, None)
            self._named_actors[key] = actor_id
            named_key = key
        actor = ActorInfo(
            actor_id=actor_id, name=name, namespace=namespace,
            state="PENDING",
            creation_spec=creation_spec, resources=dict(resources),
            max_restarts=max_restarts, pg_id=pg_id,
            owner_id=owner_id, detached=detached,
        )
        self._actors[actor_id] = actor
        self._plane_t[actor_id] = [time.monotonic(), 0.0]
        return ({"ok": True}, actor, named_key)

    def rpc_register_actor(self, conn, send_lock, *, actor_id, name,
                           creation_spec, resources, max_restarts,
                           pg_id=None, namespace=None, owner_id=None,
                           lifetime=None):
        with self._lock:
            result, created, named_key = self._register_one_locked(
                actor_id=actor_id, name=name,
                creation_spec=creation_spec, resources=resources,
                max_restarts=max_restarts, pg_id=pg_id,
                namespace=namespace, owner_id=owner_id,
                lifetime=lifetime)
            if created is not None:
                self._log_actor(created)
            if named_key is not None:
                self._log("named", named_key, actor_id)
        if created is not None or named_key is not None:
            _fi.maybe_crash("gcs.after_wal_append")
        if not result["ok"]:
            raise ValueError(result["error"])
        if created is None:
            return result
        node_id = self._schedule_actor(actor_id)
        return {"ok": True, "node_id": node_id}

    def rpc_register_actors(self, conn, send_lock, *, actors: list):
        """Batched registration (the driver-side coalescer's frame): ONE
        lock hold and ONE WAL record for the whole batch, per-actor
        idempotency/name-conflict results so one bad entry cannot fail
        its neighbors, then batch scheduling."""
        results = []
        to_schedule = []
        with self._lock:
            created_infos, named = [], {}
            for ent in actors:
                result, created, named_key = \
                    self._register_one_locked(**ent)
                results.append(result)
                if created is not None:
                    created_infos.append(created)
                    to_schedule.append(created.actor_id)
                if named_key is not None:
                    named[named_key] = ent["actor_id"]
            self._log_actors(created_infos, named)
            self._plane["register_batches"] += 1
            self._plane["register_actors"] += len(actors)
            self._plane["register_batch_max"] = max(
                self._plane["register_batch_max"], len(actors))
        # crash point: WAL record durable, client reply NOT sent — the
        # retried batch after restart must be absorbed by per-actor-id
        # idempotency, not double-registered
        _fi.maybe_crash("gcs.after_wal_append")
        node_ids = self._schedule_actors(to_schedule)
        for result, ent in zip(results, actors):
            if result["ok"] and "node_id" not in result:
                result["node_id"] = node_ids.get(ent["actor_id"])
        return {"results": results}

    def _schedule_actor(self, actor_id: str) -> str | None:
        return self._schedule_actors([actor_id]).get(actor_id)

    def _schedule_actors(self, actor_ids: list) -> dict:
        """Pick nodes for a batch of actors under ONE lock hold, group
        host requests per target raylet, and hand the batches to the
        bounded placement executor (reference: GcsActorScheduler::
        Schedule, ScheduleByGcs — no thread-per-actor)."""
        if not actor_ids:
            return {}
        results: dict[str, str | None] = {}
        assigned: dict[tuple, list] = {}   # raylet addr -> [(id, spec, inc)]
        unschedulable: list[str] = []
        with self._lock:
            occupancy: dict[str, int] = {}
            for a in self._actors.values():
                if a.node_id and a.state in ("PENDING", "ALIVE",
                                             "RESTARTING"):
                    occupancy[a.node_id] = occupancy.get(a.node_id, 0) + 1
            dirty = []
            for actor_id in actor_ids:
                actor = self._actors.get(actor_id)
                if actor is None or actor.state == "DEAD":
                    results[actor_id] = None
                    continue
                pg = self._pgs.get(actor.pg_id) if actor.pg_id else None
                node_id = self._pick_node(actor.resources, pg=pg,
                                          occupancy=occupancy)
                if node_id is None:
                    actor.state = "DEAD"
                    actor.death_reason = (
                        f"no node can host actor resources "
                        f"{actor.resources}")
                    self._plane_t.pop(actor_id, None)
                    unschedulable.append(actor_id)
                    results[actor_id] = None
                else:
                    actor.node_id = node_id
                    occupancy[node_id] = occupancy.get(node_id, 0) + 1
                    addr = tuple(self._nodes[node_id].address)
                    assigned.setdefault(addr, []).append(
                        (actor_id, actor.creation_spec,
                         actor.num_restarts))
                    results[actor_id] = node_id
                dirty.append(actor)
            self._log_actors(dirty)
        for actor_id in unschedulable:
            self.publish(CH_ACTOR, {"event": "dead", "actor_id": actor_id,
                                    "reason": "unschedulable"})
        if assigned:
            with self._place_cv:
                for addr, batch in assigned.items():
                    for i in range(0, len(batch), self._place_batch_cap):
                        self._place_queue.append(
                            (addr, batch[i:i + self._place_batch_cap]))
                self._ensure_placement_workers_locked()
                self._place_cv.notify_all()
        return results

    def _ensure_placement_workers_locked(self):
        """Lazily grow the placement pool up to its cap (caller holds
        _place_cv). The pool is the ONLY source of host_actors RPCs —
        bounded by flag, asserted by test."""
        self._place_threads = [t for t in self._place_threads
                               if t.is_alive()]
        want = min(self._place_pool_size, len(self._place_queue))
        while len(self._place_threads) < want:
            t = threading.Thread(
                target=self._placement_worker, daemon=True,
                name=f"gcs-place-{len(self._place_threads)}")
            self._place_threads.append(t)
            t.start()

    def _placement_worker(self):
        while True:
            with self._place_cv:
                while not self._place_queue and not self._stopping:
                    self._place_cv.wait(0.5)
                if self._stopping:
                    return
                addr, batch = self._place_queue.popleft()
            try:
                self._place_batch(addr, batch)
            except Exception:  # noqa: BLE001 - worker must survive
                pass

    def _place_batch(self, addr: tuple, batch: list):
        """Ship one host_actors frame to one raylet over the cached
        placement channel; per-actor results feed the failure path. The
        client is CACHED per raylet address — a 2k-actor flood through
        fresh sockets (connect + reader thread each) made placement the
        GCS bottleneck at the envelope tier."""
        from ray_tpu_torch.runtime.rpc import ConnectionLost
        wire = [{"actor_id": a, "spec": s, "incarnation": i}
                for a, s, i in batch]
        last_err: Exception | None = None
        reply = None
        for _attempt in (0, 1):
            client = None
            try:
                client = self._placement_client(addr)
                reply = client.call("host_actors", actors=wire)
                break
            except (OSError, ConnectionLost) as e:
                # transport death only: an APPLICATION error must not
                # close the SHARED channel under other in-flight
                # placements pipelined on it. One RST drains EVERY call
                # pipelined on the cached channel with ConnectionLost —
                # retry once on a fresh dial so a transient break
                # doesn't permanently kill all concurrent placements
                # (safe: host_actor dedups on (actor_id, incarnation)
                # raylet-side).
                last_err = e
                if client is not None:
                    # evict only OUR dead client: a concurrent retry
                    # may already have installed a healthy fresh
                    # channel at this address — popping that would
                    # kill its pipelined in-flight placements
                    with self._placement_lock:
                        if self._placement_clients.get(addr) is client:
                            self._placement_clients.pop(addr, None)
                    try:
                        client.close()
                    except OSError:
                        pass
            except Exception as e:  # noqa: BLE001
                last_err = e
                break
        if reply is None:
            for actor_id, _spec, _inc in batch:
                self._on_actor_failure_id(
                    actor_id, f"placement failed: {last_err!r}")
            return
        now = time.monotonic()
        with self._lock:
            self._plane["host_batches"] += 1
            self._plane["host_actors"] += len(batch)
            self._plane["host_batch_max"] = max(
                self._plane["host_batch_max"], len(batch))
            for actor_id, _spec, _inc in batch:
                t = self._plane_t.get(actor_id)
                if t is not None:
                    self._plane["place_s"] += now - t[0]
                    self._plane["placed"] += 1
                    t[1] = now
        failed = []
        for (actor_id, _spec, _inc), res in zip(batch,
                                                reply.get("results", ())):
            if not res.get("ok"):
                failed.append((actor_id,
                               res.get("error", "host_actor failed")))
        for actor_id, err in failed:
            self._on_actor_failure_id(actor_id,
                                      f"placement failed: {err}")

    def _placement_client(self, addr: tuple):
        from ray_tpu_torch.runtime.rpc import RpcClient
        with self._placement_lock:
            client = self._placement_clients.get(addr)
            if client is not None and not client._closed:
                return client
        fresh = RpcClient(addr, label="gcs")
        with self._placement_lock:
            current = self._placement_clients.get(addr)
            if current is not None and not current._closed:
                fresh.close()
                return current
            self._placement_clients[addr] = fresh
        return fresh

    def rpc_actor_ready(self, conn, send_lock, *, actor_id, node_id,
                        push_addr=None):
        reply = self.rpc_actors_ready(
            conn, send_lock, node_id=node_id,
            actors=[{"actor_id": actor_id, "push_addr": push_addr}])
        return reply["results"][0]

    def rpc_actors_ready(self, conn, send_lock, *, node_id, actors: list):
        """Batched ready acks from one raylet: one lock hold + one WAL
        record per batch; the alive events carry the full location
        (address/push_addr/incarnation) so a pubsub-driven driver never
        needs a get_actor round trip to resolve."""
        results = []
        events = []
        now = time.monotonic()
        with self._lock:
            node = self._nodes.get(node_id)
            node_addr = tuple(node.address) if node else None
            dirty = []
            for ent in actors:
                actor_id = ent["actor_id"]
                push_addr = ent.get("push_addr")
                actor = self._actors.get(actor_id)
                if actor is None:
                    results.append({"ok": False})
                    continue
                actor.state = "ALIVE"
                actor.node_id = node_id
                actor.push_addr = tuple(push_addr) if push_addr else None
                dirty.append(actor)
                results.append({"ok": True})
                t = self._plane_t.pop(actor_id, None)
                if t is not None:
                    self._plane["ready_s"] += now - (t[1] or t[0])
                    self._plane["ready"] += 1
                events.append({"event": "alive", "actor_id": actor_id,
                               "node_id": node_id, "address": node_addr,
                               "push_addr": actor.push_addr,
                               "num_restarts": actor.num_restarts})
            self._log_actors(dirty)
            self._plane["ready_batches"] += 1
            self._plane["ready_actors"] += len(actors)
        for ev in events:
            self.publish(CH_ACTOR, ev)
        return {"results": results}

    def rpc_actor_plane_stats(self, conn, send_lock, *, reset=False):
        """Creation-plane counters + phase decomposition (cumulative
        seconds and counts for register->place and place->ready; the
        envelope probe divides for per-phase means)."""
        with self._lock:
            stats = dict(self._plane)
            stats["in_flight"] = len(self._plane_t)
            if reset:
                for k in self._plane:
                    self._plane[k] = 0.0 if isinstance(
                        self._plane[k], float) else 0
            return stats

    def rpc_actor_failed(self, conn, send_lock, *, actor_id, reason):
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is not None:
            self._on_actor_failure(actor, reason)
        return {"ok": True}

    def _on_actor_failure_id(self, actor_id: str, reason: str):
        with self._lock:
            actor = self._actors.get(actor_id)
        if actor is not None:
            self._on_actor_failure(actor, reason)

    def _on_actor_failure(self, actor: ActorInfo, reason: str):
        """Restart (reference: GcsActorManager::ReconstructActor,
        gcs_actor_manager.cc:1100, max_restarts budget :1117) or kill."""
        with self._lock:
            if actor.state == "DEAD":
                return
            if actor.num_restarts < actor.max_restarts:
                actor.num_restarts += 1
                actor.state = "RESTARTING"
                actor.node_id = None
                actor.push_addr = None
                restarting = True
            else:
                actor.state = "DEAD"
                actor.death_reason = reason
                self._plane_t.pop(actor.actor_id, None)
                if actor.name:
                    key = _ns_key(actor.namespace, actor.name)
                    self._named_actors.pop(key, None)
                    self._log("named", key, None)
                restarting = False
            self._log_actor(actor)
        if restarting:
            self.publish(CH_ACTOR, {"event": "restarting",
                                    "actor_id": actor.actor_id,
                                    "reason": reason})
            self._schedule_actor(actor.actor_id)
        else:
            self.publish(CH_ACTOR, {"event": "dead",
                                    "actor_id": actor.actor_id,
                                    "reason": reason})

    def rpc_get_actor(self, conn, send_lock, *, actor_id=None, name=None,
                      namespace=None):
        with self._lock:
            if actor_id is None:
                actor_id = self._named_actors.get(
                    _ns_key(namespace or "default", name))
                if actor_id is None:
                    return None
            actor = self._actors.get(actor_id)
            if actor is None:
                return None
            node = self._nodes.get(actor.node_id) if actor.node_id else None
            return {
                "actor_id": actor.actor_id, "name": actor.name,
                "state": actor.state, "node_id": actor.node_id,
                "address": node.address if node else None,
                "push_addr": actor.push_addr,
                "death_reason": actor.death_reason,
                "num_restarts": actor.num_restarts,
            }

    def rpc_kill_actor(self, conn, send_lock, *, actor_id, no_restart=True):
        from ray_tpu_torch.runtime.rpc import RpcClient
        with self._lock:
            if actor_id not in self._actors:
                return {"ok": False}
        if no_restart:
            self._kill_actor(actor_id, "killed via ray_tpu_torch.kill()")
            return {"ok": True}
        with self._lock:
            actor = self._actors.get(actor_id)
            node = self._nodes.get(actor.node_id) if actor.node_id else None
        if node is not None:
            try:
                client = RpcClient(node.address)
                client.call("kill_actor_worker", actor_id=actor_id)
                client.close()
            except Exception:  # noqa: BLE001 - node may be gone already
                pass
        self._on_actor_failure_id(actor_id, "killed via ray_tpu_torch.kill()")
        return {"ok": True}

    def rpc_list_actors(self, conn, send_lock):
        with self._lock:
            return [
                {"actor_id": a.actor_id, "name": a.name, "state": a.state,
                 "node_id": a.node_id, "num_restarts": a.num_restarts}
                for a in self._actors.values()
            ]

    # ------------------------------------------------------------------
    # scheduling helpers (reference: HybridSchedulingPolicy — filter
    # feasible, prefer available, score by critical resource utilization)
    # ------------------------------------------------------------------

    def _pick_node(self, demand: dict, pg: PlacementGroupInfo | None = None,
                   exclude: set | None = None,
                   occupancy: dict | None = None) -> str | None:
        # zero-valued entries (num_cpus=0 actors arrive as {"CPU": 0.0})
        # are not demand: they must take the occupancy-spread path below,
        # not ride the resource-driven policy to node[0] forever
        demand = {k: v for k, v in demand.items() if v > 0}
        if pg is not None and pg.bundle_nodes:
            for nid in pg.bundle_nodes:
                n = self._nodes.get(nid)
                if n and n.alive and _fits(demand, n.available):
                    return nid
            for nid in pg.bundle_nodes:
                n = self._nodes.get(nid)
                if n and n.alive and _fits(demand, n.resources):
                    return nid
            return None
        # native hybrid policy (C++ fixed-point scoring —
        # csrc/host/scheduling.cc, built at first use)
        from ray_tpu_torch._private import scheduling as _sched

        if demand:
            # resource-driven picks: the native hybrid policy. Empty
            # demands fall through to the Python score — they tie on
            # utilization, and only the Python path knows queue depth
            # and actor occupancy (the actual spread signals).
            nodes = list(self._nodes.values())
            return _sched.pick_node(
                [n.node_id for n in nodes],
                [n.resources for n in nodes],
                [n.available for n in nodes],
                [n.alive for n in nodes],
                exclude or set(), demand,
                spread_threshold=0.0, top_k=1)
        if occupancy is None:
            occupancy = {}
            if not demand:
                # zero-resource demands tie on utilization everywhere, so
                # live-actor occupancy is the spread signal (reference:
                # GcsActorScheduler spreads; without it an envelope flood
                # stacks all 2,000 actors on node[0]). Recomputed per pick
                # — drift-free vs incremental counts across the many death
                # paths, and only empty-demand picks pay the O(actors)
                # scan. Batch scheduling passes a precomputed dict it
                # maintains incrementally (one scan per BATCH, not per
                # actor — per-pick rescans are O(n^2) at the 40k tier).
                for a in self._actors.values():
                    if a.node_id and a.state in ("PENDING", "ALIVE",
                                                 "RESTARTING"):
                        occupancy[a.node_id] = \
                            occupancy.get(a.node_id, 0) + 1
        best, best_score = None, None
        feasible_busy, busy_load = None, None
        for n in self._nodes.values():
            if not n.alive or (exclude and n.node_id in exclude):
                continue
            if not _fits(demand, n.resources):
                continue
            if _fits(demand, n.available):
                # queue depth folds into the score: a node whose
                # `available` looks healthy because per-task
                # acquire/release averages out may still hold a deep
                # ready queue — placement must prefer shallow queues
                score = (_critical_utilization(demand, n)
                         + min(n.load, 1000) * 0.001
                         + min(occupancy.get(n.node_id, 0), 100_000)
                         * 1e-6)
                if best_score is None or score < best_score:
                    best, best_score = n.node_id, score
            elif busy_load is None or n.load < busy_load:
                feasible_busy, busy_load = n.node_id, n.load
        return best if best is not None else feasible_busy

    def rpc_pick_node(self, conn, send_lock, *, demand, exclude=None,
                      pg_id=None):
        with self._lock:
            pg = self._pgs.get(pg_id) if pg_id else None
            return self._pick_node(demand, pg=pg,
                                   exclude=set(exclude or ()))

    # ------------------------------------------------------------------
    # placement groups (reference: GcsPlacementGroupManager; bundle
    # placement is 2-phase prepare/commit — simplified to reserve-on-GCS
    # because the GCS resource view is authoritative here)
    # ------------------------------------------------------------------

    def rpc_create_placement_group(self, conn, send_lock, *, pg_id, bundles,
                                   strategy="PACK"):
        with self._lock:
            alive = [n for n in self._nodes.values() if n.alive]
            assignment = _place_bundles(bundles, strategy, alive)
            if assignment is None:
                self._pgs[pg_id] = PlacementGroupInfo(
                    pg_id=pg_id, strategy=strategy, bundles=bundles,
                    state="PENDING")
                from dataclasses import asdict as _asdict
                self._log("pg", pg_id, _asdict(self._pgs[pg_id]))
                return {"ok": False, "state": "PENDING"}
            # reserve: deduct from the GCS view AND the node totals so
            # regular tasks do not oversubscribe reserved capacity
            for bundle, nid in zip(bundles, assignment):
                node = self._nodes[nid]
                for k, v in bundle.items():
                    node.available[k] = node.available.get(k, 0.0) - v
            self._pgs[pg_id] = PlacementGroupInfo(
                pg_id=pg_id, strategy=strategy, bundles=bundles,
                state="CREATED", bundle_nodes=assignment)
            from dataclasses import asdict as _asdict
            self._log("pg", pg_id, _asdict(self._pgs[pg_id]))
        return {"ok": True, "state": "CREATED", "bundle_nodes": assignment}

    def rpc_get_placement_group(self, conn, send_lock, *, pg_id):
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return None
            return {"pg_id": pg.pg_id, "state": pg.state,
                    "strategy": pg.strategy, "bundles": pg.bundles,
                    "bundle_nodes": pg.bundle_nodes}

    def rpc_list_placement_groups(self, conn, send_lock):
        with self._lock:
            return [{"pg_id": pg.pg_id, "state": pg.state,
                     "strategy": pg.strategy,
                     "bundle_nodes": pg.bundle_nodes}
                    for pg in self._pgs.values()]

    def rpc_remove_placement_group(self, conn, send_lock, *, pg_id):
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg is not None:
                self._log("pg", pg_id, None)
            if pg is not None and pg.state == "CREATED":
                for bundle, nid in zip(pg.bundles, pg.bundle_nodes):
                    node = self._nodes.get(nid)
                    if node is not None:
                        for k, v in bundle.items():
                            node.available[k] = node.available.get(k, 0) + v
        return {"ok": True}

    # ------------------------------------------------------------------
    # object directory (centralized; reference is owner-based
    # OwnershipBasedObjectDirectory — see SURVEY §2a N7)
    # ------------------------------------------------------------------

    def rpc_add_object_location(self, conn, send_lock, *, oid, node_id,
                                size=0):
        with self._lock:
            if oid in self._ref_released:
                # free-on-arrival: every reference was dropped before the
                # object materialized (fire-and-forget task returns)
                self._pending_release.setdefault(node_id, set()).add(oid)
                return {"ok": True}
            self._object_dir.setdefault(oid, set()).add(node_id)
            self._lost_objects.pop(oid, None)  # re-created (reconstruction)
            if size:
                self._object_meta[oid] = size
        self.publish(CH_OBJECT, {"event": "added", "oid": oid,
                                 "node_id": node_id})
        return {"ok": True}

    def rpc_add_object_locations(self, conn, send_lock, *, node_id,
                                 entries):
        """Batched location registration (raylets buffer task-return
        locations and flush them together — one directory RPC per flush
        instead of per task; the hot-path win behind the reference's
        ownership-based directory being OFF the task critical path)."""
        live = []
        with self._lock:
            for oid, size in entries:
                if oid in self._ref_released:
                    self._pending_release.setdefault(node_id,
                                                     set()).add(oid)
                    continue
                self._object_dir.setdefault(oid, set()).add(node_id)
                self._lost_objects.pop(oid, None)
                if size:
                    self._object_meta[oid] = size
                live.append(oid)
        for oid in live:
            self.publish(CH_OBJECT, {"event": "added", "oid": oid,
                                     "node_id": node_id})
        return {"ok": True}

    def rpc_get_object_locations(self, conn, send_lock, *, oids):
        with self._lock:
            return {oid: sorted(self._object_dir.get(oid, ()))
                    for oid in oids}

    def _tombstone(self, oid: str, reason: str = "?"):
        """Record a lost object, dropping the oldest past the cap (caller
        holds the lock). The reason is diagnostic: which path removed
        the LAST copy matters when debugging scale runs."""
        self._lost_objects[oid] = reason
        while len(self._lost_objects) > self._max_lost_objects:
            self._lost_objects.pop(next(iter(self._lost_objects)))

    def rpc_get_lost_objects(self, conn, send_lock, *, oids):
        """Subset of ``oids`` that were known and whose every copy died
        with its node (lineage-reconstruction trigger)."""
        with self._lock:
            return [o for o in oids if o in self._lost_objects]

    def rpc_debug_counts(self, conn, send_lock):
        """Diagnostic sizes of the hot tables (scale-run hunts)."""
        with self._lock:
            return {"object_dir": len(self._object_dir),
                    "ref_holders": len(self._ref_holders),
                    "ref_released": len(self._ref_released),
                    "pending_release": sum(
                        len(v) for v in self._pending_release.values()),
                    "lost": len(self._lost_objects)}

    def rpc_get_lost_reasons(self, conn, send_lock, *, oids):
        """Diagnostic: tombstone reasons for lost oids."""
        with self._lock:
            return {o: self._lost_objects.get(o) for o in oids}

    def rpc_remove_object_location(self, conn, send_lock, *, oid, node_id):
        with self._lock:
            locs = self._object_dir.get(oid)
            if locs:
                locs.discard(node_id)
                if not locs:
                    # last copy gone (evicted secondary after the primary's
                    # node died, or explicit free): tombstone so owners can
                    # reconstruct from lineage
                    del self._object_dir[oid]
                    self._tombstone(oid, f"removed_by:{node_id[:8]}")
        return {"ok": True}

    # ------------------------------------------------------------------
    # distributed refcounting (reference: reference_count.h:61-115 — the
    # owner/borrower protocol, centralized: every client reports holder
    # transitions, task pins, and contains-edges; zero count => release)
    # ------------------------------------------------------------------

    @staticmethod
    def _trim(table: dict, cap: int):
        while len(table) > cap:
            table.pop(next(iter(table)))

    def _ref_count(self, oid: str) -> int:
        return (len(self._ref_holders.get(oid, ()))
                + self._ref_pin_count.get(oid, 0)
                + self._ref_contained.get(oid, 0))

    def _touch_client(self, client_id: str, kind: str | None = None) -> bool:
        """Refresh client liveness. Returns True when the client was
        previously reaped and is being resurrected — its holds were
        dropped, so the caller must tell it to re-sync its held set."""
        c = self._clients.get(client_id)
        if c is None:
            self._clients[client_id] = {"kind": kind or "unknown",
                                        "last_seen": time.monotonic(),
                                        "alive": True}
            return False
        c["last_seen"] = time.monotonic()
        if kind and c["kind"] == "unknown":
            c["kind"] = kind
        if not c["alive"]:
            # back from the dead (GC pause / partition outlived the
            # timeout): resurrect so its future holds are reclaimable,
            # and fence — it must re-register everything it still holds
            c["alive"] = True
            return True
        return False

    @staticmethod
    def _dec_counts(table: dict, oids, dec: set):
        """Decrement ``table[oid]`` for each oid, popping zeros into
        ``dec`` (the release-candidate set). Shared by the pin-release,
        owner-death, and contains-release paths."""
        for oid in oids:
            n = table.get(oid, 0) - 1
            if n <= 0:
                table.pop(oid, None)
                dec.add(oid)
            else:
                table[oid] = n

    def rpc_register_client(self, conn, send_lock, *, client_id,
                            kind="driver"):
        with self._lock:
            self._touch_client(client_id, kind)
        return {"ok": True}

    def rpc_unregister_client(self, conn, send_lock, *, client_id):
        """Clean client shutdown: drop its ref contributions now and
        reap its non-detached actors (reference: job/driver exit kills
        owned actors, gcs_actor_manager.cc:632)."""
        self._reap_client(client_id, "client disconnected")
        return {"ok": True}

    def rpc_ref_update(self, conn, send_lock, *, client_id, add=(),
                       remove=(), transient=(), pins=(), pin_releases=(),
                       contains=(), kind=None):
        """Batched per-client refcount deltas; doubles as the client
        liveness heartbeat. Adds/pins/contains are applied before
        removes so one batch carrying both orders correctly."""
        dec: set[str] = set()
        with self._lock:
            resync = self._touch_client(client_id, kind)
            for oid in add:
                self._ref_holders.setdefault(oid, set()).add(client_id)
            for task_id, oids in pins:
                if task_id in self._pin_released:
                    # the executor finished (and released) before the
                    # owner's pin landed: consume the tombstone
                    del self._pin_released[task_id]
                    continue
                if task_id in self._ref_pins:
                    continue
                self._ref_pins[task_id] = (client_id, list(oids))
                for oid in oids:
                    self._ref_pin_count[oid] = \
                        self._ref_pin_count.get(oid, 0) + 1
            for outer, inners in contains:
                if outer in self._ref_contains \
                        or outer in self._ref_released:
                    continue
                self._ref_contains[outer] = list(inners)
                for oid in inners:
                    self._ref_contained[oid] = \
                        self._ref_contained.get(oid, 0) + 1
            for task_id in pin_releases:
                entry = self._ref_pins.pop(task_id, None)
                if entry is None:
                    self._pin_released[task_id] = None
                    self._trim(self._pin_released, 200_000)
                    continue
                self._dec_counts(self._ref_pin_count, entry[1], dec)
            for oid in remove:
                holders = self._ref_holders.get(oid)
                if holders is not None:
                    holders.discard(client_id)
                    if not holders:
                        self._ref_holders.pop(oid, None)
                    dec.add(oid)
            # transient = held-and-dropped within one client flush window
            # (the hold never registered): a pure decrement event
            dec.update(transient)
            self._release_zeroed(dec)
        if resync:
            return {"ok": True, "resync": True}
        return {"ok": True}

    def _release_zeroed(self, oids):
        """Release objects whose count dropped to zero (lock held).
        Releases are triggered only by DECREMENTS — an object tracked
        but never held (e.g. a contains-edge reported before the owner's
        first flush) just waits."""
        for oid in oids:
            if oid not in self._ref_released and self._ref_count(oid) == 0:
                self._release_object(oid)

    def _release_object(self, oid: str):
        """Free one object's copies cluster-wide (lock held): pull it
        from the directory, queue a release on every node that holds a
        copy, and (after a grace) release anything it contained."""
        self._ref_released[oid] = None
        self._trim(self._ref_released, 500_000)
        locs = self._object_dir.pop(oid, None)
        self._object_meta.pop(oid, None)
        if locs:
            for node_id in locs:
                self._pending_release.setdefault(node_id, set()).add(oid)
        inners = self._ref_contains.pop(oid, None)
        if inners:
            # grace: a borrower that just deserialized the outer may have
            # increfs for the inners still in flight
            self._deferred_contains.append(
                (time.monotonic() + self._ref_grace, inners))
        self._ref_holders.pop(oid, None)
        self._ref_pin_count.pop(oid, None)
        self._ref_contained.pop(oid, None)

    def _process_deferred_contains(self):
        now = time.monotonic()
        with self._lock:
            due, keep = [], []
            for item in self._deferred_contains:
                (due if item[0] <= now else keep).append(item)
            self._deferred_contains = keep
            dec: set[str] = set()
            for _, inners in due:
                self._dec_counts(self._ref_contained, inners, dec)
            self._release_zeroed(dec)

    def _reap_stale_clients(self):
        now = time.monotonic()
        with self._lock:
            stale = [cid for cid, c in self._clients.items()
                     if c["alive"]
                     and now - c["last_seen"] > self._client_timeout]
            # prune long-dead entries: every driver session otherwise
            # leaves a permanent _clients row (the 60s linger keeps the
            # resurrection fence effective across brief outages)
            for cid in [cid for cid, c in self._clients.items()
                        if not c["alive"]
                        and now - c["last_seen"] > 60.0]:
                del self._clients[cid]
        for cid in stale:
            self._reap_client(cid, "client heartbeat timeout")

    def _reap_client(self, client_id: str, reason: str):
        """A driver/worker runtime died: drop every ref contribution it
        held and kill its non-detached actors (reference: owner-death
        handling in ReferenceCounter + GcsActorManager)."""
        with self._lock:
            c = self._clients.get(client_id)
            if c is not None and not c["alive"]:
                return
            if c is not None:
                c["alive"] = False
            dec: set[str] = set()
            for oid, holders in list(self._ref_holders.items()):
                if client_id in holders:
                    holders.discard(client_id)
                    if not holders:
                        self._ref_holders.pop(oid, None)
                    dec.add(oid)
            for task_id, (owner, oids) in list(self._ref_pins.items()):
                if owner != client_id:
                    continue
                del self._ref_pins[task_id]
                self._dec_counts(self._ref_pin_count, oids, dec)
            self._release_zeroed(dec)
            doomed = [a.actor_id for a in self._actors.values()
                      if a.owner_id == client_id and not a.detached
                      and a.state != "DEAD"]
        for actor_id in doomed:
            self._kill_actor(actor_id, f"owner {client_id[:8]} died: "
                                       f"{reason}")

    def _kill_actor(self, actor_id: str, reason: str):
        """Terminate an actor with no restart (shared by kill() and
        owner-death reaping)."""
        from ray_tpu_torch.runtime.rpc import RpcClient
        with self._lock:
            actor = self._actors.get(actor_id)
            if actor is None:
                return
            actor.max_restarts = actor.num_restarts  # exhaust budget
            node = self._nodes.get(actor.node_id) if actor.node_id else None
        if node is not None:
            try:
                client = RpcClient(node.address)
                client.call("kill_actor_worker", actor_id=actor_id)
                client.close()
            except Exception:  # noqa: BLE001 - node may be gone already
                pass
        self._on_actor_failure_id(actor_id, reason)

    # ------------------------------------------------------------------
    # KV (reference: GcsKvManager / internal_kv)
    # ------------------------------------------------------------------

    def rpc_kv_put(self, conn, send_lock, *, ns, key, value,
                   overwrite=True):
        with self._lock:
            table = self._kv.setdefault(ns, {})
            if not overwrite and key in table:
                return {"ok": False}
            table[key] = value
            self._log("kv", (ns, key), value)
        # crash point BEFORE the fault-plan self-apply below: a plan
        # arriving through this very handler must not trip its own crash
        # rule on the write that installs it — only the NEXT WAL append
        # (e.g. the retried durable put) can fire
        _fi.maybe_crash("gcs.after_wal_append")
        if ns == _fi.KV_NS and key == _fi.KV_KEY:
            # the fault-plan switch key: other processes poll it, the
            # GCS applies it to its own plane at write time (outside the
            # KV lock — load_plan takes the plane's own lock)
            try:
                _fi.plane.load_plan(_fi.decode_plan(value))
            except Exception:  # noqa: BLE001 - bad plan must not break KV
                pass
        return {"ok": True}

    def rpc_kv_get(self, conn, send_lock, *, ns, key):
        with self._lock:
            return self._kv.get(ns, {}).get(key)

    def rpc_kv_del(self, conn, send_lock, *, ns, key):
        with self._lock:
            hit = self._kv.get(ns, {}).pop(key, None) is not None
            if hit:
                self._log("kv", (ns, key), None)
            return {"ok": hit}

    def rpc_kv_keys(self, conn, send_lock, *, ns, prefix=""):
        with self._lock:
            return [k for k in self._kv.get(ns, {}) if k.startswith(prefix)]

    # ------------------------------------------------------------------
    # jobs + task events (reference: GcsJobManager, GcsTaskManager)
    # ------------------------------------------------------------------

    def rpc_register_job(self, conn, send_lock, *, job_id, metadata=None):
        with self._lock:
            self._jobs[job_id] = {"job_id": job_id, "state": "RUNNING",
                                  "start_time": time.time(),
                                  "metadata": metadata or {}}
            self._log("job", job_id, dict(self._jobs[job_id]))
        return {"ok": True}

    def rpc_list_jobs(self, conn, send_lock):
        with self._lock:
            return list(self._jobs.values())

    def rpc_add_task_events(self, conn, send_lock, *, events):
        with self._lock:
            self._task_events.extend(events)
            if len(self._task_events) > self._max_task_events:
                del self._task_events[:-self._max_task_events]
        return {"ok": True}

    def rpc_report_demand(self, conn, send_lock, *, node_id, demands):
        """Per-node unmet resource demand (reference:
        GcsAutoscalerStateManager's cluster resource state feeding the
        autoscaler)."""
        with self._lock:
            if demands:
                self._pending_demand[node_id] = list(demands)
            else:
                self._pending_demand.pop(node_id, None)
        return True

    def rpc_get_pending_demand(self, conn, send_lock):
        with self._lock:
            return [d for ds in self._pending_demand.values() for d in ds]

    def rpc_get_task_events(self, conn, send_lock, *, limit=1000):
        with self._lock:
            return self._task_events[-limit:]

    # ------------------------------------------------------------------
    # cluster summary
    # ------------------------------------------------------------------

    def rpc_cluster_resources(self, conn, send_lock):
        total: dict[str, float] = {}
        avail: dict[str, float] = {}
        with self._lock:
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources.items():
                    total[k] = total.get(k, 0.0) + v
                for k, v in n.available.items():
                    avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}


def main():
    """Run the GCS as a standalone process (reference:
    ``gcs_server_main.cc`` — the control plane is its own process).
    cluster_utils spawns this for ``Cluster(external_gcs=True)``."""
    import json
    import signal
    import sys

    # role stamp BEFORE construction: crash rules scoped proc="gcs" may
    # only ever kill a standalone control plane, never a driver-hosted
    # in-process GcsServer (whose process keeps the "driver" label)
    _fi.set_process_label("gcs")
    cfg = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    server = GcsServer(
        host=cfg.get("host", "127.0.0.1"),
        port=cfg.get("port", 0),
        heartbeat_timeout_s=cfg.get("heartbeat_timeout_s", 5.0),
        persistence_dir=cfg.get("persistence_dir"),
    ).start()
    stop_ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_ev.set())
    signal.signal(signal.SIGINT, lambda *_: stop_ev.set())
    print(json.dumps({"address": server.address}), flush=True)
    try:
        stop_ev.wait()
    finally:
        server.stop()


# RPCs that only the observability planes serve (their stores, the
# memory-plane joins over their annexes, the profilers): a later slice
_PLANE_RPCS = (
    "push_logs", "register_agent", "push_metrics", "query_metrics",
    "query_metric_annexes", "memory_table", "memory_summary",
    "memory_leaks", "push_spans", "get_trace", "list_traces", "stuck_calls",
    "flight_record", "get_log", "list_logs", "summarize_errors",
    "dump_stacks", "profile",
)


def _plane_rpc(name: str):
    def handler(self, conn, send_lock, **kwargs):
        raise NotImplementedError(
            f"GCS rpc {name!r} belongs to the observability planes, a "
            "later slice of the port")
    handler.__name__ = f"rpc_{name}"
    return handler


for _name in _PLANE_RPCS:
    setattr(GcsServer, f"rpc_{_name}", _plane_rpc(_name))


def _ns_key(namespace: str, name: str) -> str:
    """Registry key scoping a named actor to its namespace (the unit
    separator cannot appear in user-visible names by convention)."""
    return f"{namespace}\x1f{name}"


def _fits(demand: dict, supply: dict) -> bool:
    return all(supply.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _critical_utilization(demand: dict, node: NodeInfo) -> float:
    """Score = max over demanded resources of (used+demand)/total; lower is
    better (reference: hybrid_scheduling_policy.cc:99-186)."""
    score = 0.0
    for k, v in demand.items():
        total = node.resources.get(k, 0.0)
        if total <= 0:
            continue
        used = total - node.available.get(k, 0.0)
        score = max(score, (used + v) / total)
    return score


def _place_bundles(bundles: list, strategy: str, nodes: list):
    """Greedy bundle placement. Returns node_id per bundle or None.
    (The JAX package's ``SLICE_PACK``, which keeps a group within one TPU
    slice, has no counterpart on one host.)"""
    avail = {n.node_id: dict(n.available) for n in nodes}
    order = sorted(avail, key=lambda nid: -sum(avail[nid].values()))
    assignment = []
    if strategy in ("STRICT_PACK", "PACK"):
        # try single node first
        for nid in order:
            trial = dict(avail[nid])
            ok = True
            for b in bundles:
                if _fits(b, trial):
                    for k, v in b.items():
                        trial[k] -= v
                else:
                    ok = False
                    break
            if ok:
                return [nid] * len(bundles)
        if strategy == "STRICT_PACK":
            return None
    if strategy == "STRICT_SPREAD" and len(bundles) > len(nodes):
        return None
    used_nodes: set[str] = set()
    for b in bundles:
        placed = None
        if strategy == "PACK":
            # pack: fill nodes already in use before opening new ones —
            # preferring fresh nodes here fragments capacity and can
            # make a feasible packing spuriously infeasible
            candidates = ([nid for nid in order if nid in used_nodes]
                          + [nid for nid in order if nid not in used_nodes])
        else:
            # spread: prefer unused nodes; fall back to reuse
            candidates = ([nid for nid in order if nid not in used_nodes]
                          + [nid for nid in order if nid in used_nodes])
        if strategy == "STRICT_SPREAD":
            candidates = [nid for nid in order if nid not in used_nodes]
        for nid in candidates:
            if _fits(b, avail[nid]):
                for k, v in b.items():
                    avail[nid][k] -= v
                placed = nid
                used_nodes.add(nid)
                break
        if placed is None:
            return None
        assignment.append(placed)
    return assignment


if __name__ == "__main__":
    main()
