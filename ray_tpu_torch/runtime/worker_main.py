"""Worker process main loop.

Port of ``ray_tpu/runtime/worker_main.py``. Functions, classes and
arguments arrive as the port's stdlib-pickle blobs
(``runtime/serialization.py``). With JAX's runtime environments (applied
at boot from ``RAY_TPU_TORCH_RUNTIME_ENV``), fault-injection crash points
(``worker.mid_task``, ``worker.mid_actor_task``) and the zygote template
mode of the prestart fork server (``--zygote``,
``runtime/prestart.py``). Left for later slices: the log capture, metrics
pusher, trace spans and profiling RPCs (the observability planes).

Reference analog: ``python/ray/_private/workers/default_worker.py`` +
the execution callback ``execute_task`` in ``_raylet.pyx:1457``. The worker
registers with its raylet (handshake: ``worker_pool.cc``), then serves tasks
pushed over the registration channel:

- ``task``: a normal task — resolve args, run, store returns in shm.
- ``create_actor``: instantiate and pin the actor instance; subsequent
  ``actor_task`` messages run methods in per-caller submission order
  (reference: SequentialActorSubmitQueue + ActorSchedulingQueue).

Objects are read/written via direct shm attach (zero-copy); the raylet is
informed of each put so it can register locations with the GCS.
"""

from __future__ import annotations

import os
import threading
import traceback
from collections import defaultdict

from ray_tpu_torch._private.shm_store import ShmObjectStore
from ray_tpu_torch.runtime import object_codec
from ray_tpu_torch.runtime import serialization
from ray_tpu_torch.runtime.rpc import (
    ReconnectingRpcClient,
    RpcClient,
    RpcServer,
    recv_msg,
    send_msg,
)
from ray_tpu_torch.utils import exceptions as exc


class TaskPushServer(RpcServer):
    """Owner-facing task port (reference: the worker-side gRPC PushTask
    service the lease protocol pushes to, ``direct_task_transport.cc:234``).

    A lease IS a live connection here: the owner that holds the lease
    pushes tasks over it and gets the completion as the RPC reply; when
    the connection drops (owner returned the lease, or died), the worker
    tells its raylet so the lease's worker+resources return to the pool.
    """

    # push-reply replay cache bounds (entries AND payload bytes: direct
    # results ride replies, so cached replies hold real data)
    REPLY_CACHE_ENTRIES = 512
    REPLY_CACHE_BYTES = 8 << 20

    def __init__(self, worker: "Worker"):
        super().__init__("127.0.0.1", 0)
        self._worker = worker
        # task push idempotency: a duplicated delivery (lost reply →
        # owner re-push, or an injected duplicate) must NOT re-execute —
        # and must return the FIRST reply VERBATIM, because direct
        # results ride the reply and exist nowhere else. key: task_id
        # (singular push) or tuple of task_ids (batched push).
        from collections import OrderedDict
        self._push_replies: OrderedDict = OrderedDict()
        self._push_reply_bytes = 0
        self._push_reply_lock = threading.Lock()

    def _cached_push_reply(self, key):
        if not key:
            return None
        with self._push_reply_lock:
            entry = self._push_replies.get(key)
        return entry[0] if entry is not None else None

    @staticmethod
    def _reply_nbytes(reply: dict) -> int:
        n = 256
        for v in (reply.get("results") or {}).values():
            try:
                n += len(v)
            except TypeError:
                n += 256
        return n

    def _remember_push_reply(self, key, reply: dict):
        if not key:
            return
        nbytes = self._reply_nbytes(reply)
        with self._push_reply_lock:
            self._push_replies[key] = (reply, nbytes)
            self._push_reply_bytes += nbytes
            while (len(self._push_replies) > self.REPLY_CACHE_ENTRIES
                   or self._push_reply_bytes > self.REPLY_CACHE_BYTES):
                _, (_, old) = self._push_replies.popitem(last=False)
                self._push_reply_bytes -= old

    def _run_one(self, task: dict):
        w = self._worker
        tid = task.get("task_id", "")
        if task.get("cancelled") or tid in w.cancelled_push_ids:
            return  # cancel error pre-stored by the raylet
        w.current_push_task_id = tid
        try:
            w._execute(task)
        finally:
            w.current_push_task_id = None

    def rpc_lease_attach(self, conn, send_lock):
        """Explicit lease handshake: the owner's FIRST request on a lease
        connection. Only connections tagged here (or by a task push, the
        fallback) count as lease channels — direct actor callers share
        this port,
        and their disconnects must NOT release the lease."""
        self._tag_lease_conn(conn)
        return {"ok": True}

    def _tag_lease_conn(self, conn):
        with self._worker._push_conn_lock:
            self._worker.lease_conns.add(conn)

    def rpc_push_task(self, conn, send_lock, *, task: dict):
        # expose the executing thread so the cancel path can interrupt
        # THIS thread — the main thread only runs the raylet-channel
        # recv loop
        self._tag_lease_conn(conn)
        cached = self._cached_push_reply(task.get("task_id"))
        if cached is not None:
            return cached
        self._worker.push_task_thread = threading.current_thread()
        # small returns ride the reply to the OWNER's store (reference:
        # in-process memory store for direct-call returns) — no shm
        # write, no pin report, no cross-node pull for tiny results
        sink: dict = {}
        task["_direct_sink"] = sink
        try:
            self._run_one(task)
        finally:
            self._worker.push_task_thread = None
        reply = {"ok": True, "task_id": task.get("task_id")}
        if sink:
            reply["results"] = sink
        self._remember_push_reply(task.get("task_id"), reply)
        return reply

    def rpc_push_tasks(self, conn, send_lock, *, tasks: list):
        """Batched push: one RPC carries several tasks, executed in
        order (the owner packs bursts of small same-shape tasks — one
        framed round trip instead of N)."""
        self._tag_lease_conn(conn)
        batch_key = tuple(t.get("task_id", "") for t in tasks)
        cached = self._cached_push_reply(batch_key)
        if cached is not None:
            return cached
        self._worker.push_task_thread = threading.current_thread()
        sink: dict = {}
        try:
            for task in tasks:
                task["_direct_sink"] = sink
                self._run_one(task)
        finally:
            self._worker.push_task_thread = None
        reply = {"ok": True}
        if sink:
            reply["results"] = sink
        self._remember_push_reply(batch_key, reply)
        return reply

    def rpc_submit_actor_task(self, conn, send_lock, *, task: dict):
        """DIRECT actor-task submission (owner → actor process, no raylet
        hop — reference: DirectActorTaskSubmitter pushing straight to the
        actor's gRPC queue). Same method name and semantics as the
        raylet-mediated path; the per-caller seq buffer keeps ordering
        across both."""
        w = self._worker
        if w.actor_id is None or task.get("actor_id") != w.actor_id:
            raise LookupError(
                f"actor {task.get('actor_id')} not hosted by this worker")
        if task.get("incarnation", 0) != w.actor_incarnation:
            # caller's numbering belongs to another incarnation — reject
            # so it refreshes (same contract as the raylet check)
            raise LookupError(
                f"actor {w.actor_id} incarnation mismatch "
                f"(task {task.get('incarnation')} != "
                f"{w.actor_incarnation})")
        # ack on ENQUEUE, execute on the actor-executor thread: the
        # raylet path acks pre-execution too, and an inline execution of
        # a self-terminating method (os._exit) would swallow the ack —
        # the owner would then RESEND the killer to the restarted
        # incarnation and burn its whole restart budget
        task["_direct"] = True   # no raylet bookkeeping: skip task_done
        w._enqueue_actor_task(task)
        return {"ok": True}

    def rpc_submit_actor_tasks(self, conn, send_lock, *, tasks: list):
        """Batched direct actor submission: the owner's flusher packs a
        burst of calls into one frame (one pickle+syscall per burst).
        Validation matches the singular path; a mismatch fails the whole
        frame and the owner resends task-by-task (worker-side seq dedup
        makes re-delivery of the already-enqueued prefix harmless)."""
        w = self._worker
        for task in tasks:
            if w.actor_id is None or task.get("actor_id") != w.actor_id:
                raise LookupError(
                    f"actor {task.get('actor_id')} not hosted by this worker")
            if task.get("incarnation", 0) != w.actor_incarnation:
                raise LookupError(
                    f"actor {w.actor_id} incarnation mismatch "
                    f"(task {task.get('incarnation')} != "
                    f"{w.actor_incarnation})")
            task["_direct"] = True   # no raylet bookkeeping: skip task_done
            w._enqueue_actor_task(task)
        return {"ok": True}

    def on_disconnect(self, conn):
        # Release the lease only when the LAST lease-tagged connection
        # drops. A profiler or direct actor caller disconnecting from a
        # leased worker previously fired lease_closed too, flipping the
        # worker idle while the owner still held its channel — two tasks
        # could then run concurrently on a one-slot worker.
        with self._worker._push_conn_lock:
            was_lease = conn in self._worker.lease_conns
            self._worker.lease_conns.discard(conn)
            any_left = bool(self._worker.lease_conns)
        if not was_lease or any_left:
            return
        try:
            self._worker.ctrl.call("lease_closed",
                                   worker_id=self._worker.worker_id)
        except Exception:  # noqa: BLE001 - raylet is gone; worker will exit
            pass


class Worker:
    def __init__(self):
        # Apply this worker's runtime env BEFORE anything else: env_vars,
        # cached working_dir (chdir), py_modules on sys.path (reference:
        # the runtime-env agent prepares the context applied at worker
        # start — _private/runtime_env/agent/runtime_env_agent.py:281).
        renv_raw = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
        if renv_raw:
            import json as _json

            from ray_tpu_torch.runtime_env import apply_runtime_env, env_key

            renv = _json.loads(renv_raw)
            try:
                apply_runtime_env(renv)
            except Exception as e:  # noqa: BLE001
                # tell the raylet WHY before dying: otherwise the queued
                # task respawns a fresh worker that re-fails the same
                # install forever, and the error never leaves stderr
                try:
                    failer = RpcClient(
                        (os.environ["RAY_TPU_TORCH_RAYLET_HOST"],
                         int(os.environ["RAY_TPU_TORCH_RAYLET_PORT"])))
                    failer.call("runtime_env_failed",
                                key=env_key(renv), error=repr(e))
                    failer.close()
                except Exception:  # noqa: BLE001
                    pass
                raise
        host = os.environ["RAY_TPU_TORCH_RAYLET_HOST"]
        port = int(os.environ["RAY_TPU_TORCH_RAYLET_PORT"])
        self.worker_id = os.environ["RAY_TPU_TORCH_WORKER_ID"]
        self.node_id = os.environ["RAY_TPU_TORCH_NODE_ID"]
        self.raylet_addr = (host, port)
        from ray_tpu_torch.runtime import fault_injection as _fi
        _fi.maybe_init_from_config(
            (os.environ["RAY_TPU_TORCH_GCS_HOST"],
             int(os.environ["RAY_TPU_TORCH_GCS_PORT"])),
            process_label="worker")
        self.store = ShmObjectStore(os.environ["RAY_TPU_TORCH_STORE_NAME"])
        # control client: request/response to the raylet (ensure_local etc.)
        self.ctrl = RpcClient(self.raylet_addr, label="worker")
        # task-event reporting to the GCS sink (lazy buffer)
        self._gcs = ReconnectingRpcClient((os.environ["RAY_TPU_TORCH_GCS_HOST"],
                               int(os.environ["RAY_TPU_TORCH_GCS_PORT"])),
                               label="worker")
        self._event_buf: list[dict] = []
        self._event_lock = threading.Lock()
        self._last_flush = 0.0
        # periodic flusher: without it, the tail of a burst (<batch size)
        # strands in the buffer until the next task happens to run
        threading.Thread(target=self._flush_loop, daemon=True,
                         name="task-event-flusher").start()
        # actor state
        self.actor_instance = None
        self.actor_id = None
        self.actor_incarnation = 0
        self.actor_namespace = None
        # asyncio mode (reference: async actors run coroutine methods on
        # fibers — core_worker/fiber.h:17; here: one event loop thread,
        # concurrency bounded by an asyncio.Semaphore(max_concurrency))
        self._actor_loop = None
        self._actor_sem = None
        # ONE executor thread runs actor methods in arrival order no
        # matter which path delivered them (raylet channel or direct
        # owner push) — actor semantics are one method at a time
        import queue as _queue

        self._actor_exec_q: _queue.Queue = _queue.Queue()
        self._actor_exec_started = False
        self._seq_lock = threading.Lock()
        self._next_seq = defaultdict(int)       # caller -> next seq
        self._seq_buffer = defaultdict(dict)    # caller -> {seq: task}
        # cancel routing: SIGINT lands in the main thread; when a pushed
        # (leased) task is executing on a server thread, re-aim the
        # KeyboardInterrupt at that thread instead
        self.push_task_thread: threading.Thread | None = None
        # targeted cancel of leased tasks: ids to skip if not yet started,
        # and the id currently executing (so an interrupt only ever hits
        # the task it was aimed at — never a batchmate)
        self.current_push_task_id: str | None = None
        self.cancelled_push_ids: set[str] = set()
        self.lease_conns: set = set()   # open conns tagged as lease channels
        self._push_conn_lock = threading.Lock()
        self._lease_watch_gen = 0
        self._fn_cache: dict[int, tuple] = {}   # hash(blob) -> (blob, fn)
        self._fn_id_cache: dict[str, object] = {}   # fn_id -> fn
        self._report_buf: list[tuple[str, int]] = []
        self._report_cv = threading.Condition()
        threading.Thread(target=self._report_flush_loop, daemon=True,
                         name="report-flusher").start()
        # --- distributed refcounting (runtime/refcount.py): this worker
        # owns the process's ref flush channel — nested in-worker
        # runtimes piggyback on it (claim_flusher). It reports refs the
        # worker retains (actor state), releases task arg pins after
        # execution, and heartbeats client liveness. ---
        from ray_tpu_torch.runtime import refcount as _refcount
        from ray_tpu_torch.utils.config import get_config as _get_config
        _cfg = _get_config()
        self._refs = _refcount.global_counter
        self._ref_enabled = _cfg.ref_counting_enabled
        self._direct_limit = _cfg.max_direct_call_object_size
        self._fn_cache_cap = _cfg.worker_fn_cache_size
        self._event_batch = _cfg.task_event_batch_size
        self._event_flush_s = _cfg.task_event_flush_interval_s
        self._report_linger_s = _cfg.put_report_linger_s
        self._ref_send_lock = threading.Lock()
        if self._ref_enabled:
            _refcount.claim_flusher(self.worker_id)
            try:
                self._gcs.call("register_client",
                               client_id=self.worker_id, kind="worker")
            except Exception:  # noqa: BLE001 - reconnecting client
                pass
            threading.Thread(target=self._ref_flush_loop, daemon=True,
                             name="ref-flusher").start()
        self._install_sigint_router()
        # Owner-facing push port, then registration — ALL execution state
        # above must exist first: the instant registration lands, the
        # raylet may lease this worker and an owner may push a task.
        self.push_server = TaskPushServer(self).start()
        import socket as _socket
        self.chan = _socket.create_connection(self.raylet_addr)
        self.chan.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self.chan_lock = threading.Lock()
        send_msg(self.chan, {"method": "register_worker",
                             "worker_id": self.worker_id,
                             "push_addr": list(self.push_server.address)})
        reply = recv_msg(self.chan)
        assert reply.get("registered"), reply

    def _arm_lease_watch(self):
        """The raylet granted a lease on this worker: if the owner never
        dials the push port (it died, or its dial failed after the
        grant), hand the lease back — otherwise this worker and its
        resources leak in 'leased' state forever. The check is on OPEN
        LEASE-TAGGED connections (not connection history, and not mere
        open connections — an observability probe must not mask an owner
        that never dialed), so an owner that attached before this message
        was processed is never falsely reclaimed; an owner that dialed
        and died is covered by on_disconnect."""
        import time as _time

        from ray_tpu_torch.utils.config import get_config as _get_config

        timeout = _get_config().lease_never_dialed_timeout_s
        self._lease_watch_gen += 1
        gen = self._lease_watch_gen

        def watch():
            _time.sleep(timeout)
            with self._push_conn_lock:
                active = len(self.lease_conns)
            # the gen check keeps a STALE watch (armed for a previous
            # lease cycle) from reclaiming a newer grant
            if active == 0 and gen == self._lease_watch_gen:
                try:
                    self.ctrl.call("lease_closed", worker_id=self.worker_id)
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=watch, daemon=True,
                         name="lease-watch").start()

    def _cancel_push(self, task_id: str):
        """Cancel a lease-pushed task BY ID: interrupt only if it is the
        one currently executing; otherwise flag it so the push loop skips
        it. (A raw SIGINT would hit whatever batchmate happens to be
        running.)"""
        import ctypes

        self.cancelled_push_ids.add(task_id)
        while len(self.cancelled_push_ids) > 1024:
            self.cancelled_push_ids.pop()
        t = self.push_task_thread
        if (t is not None and t.is_alive()
                and self.current_push_task_id == task_id):
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(t.ident), ctypes.py_object(KeyboardInterrupt))

    def _install_sigint_router(self):
        import ctypes
        import signal

        def _route(signum, frame):
            t = self.push_task_thread
            if t is not None and t.is_alive():
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_long(t.ident),
                    ctypes.py_object(KeyboardInterrupt))
            else:
                raise KeyboardInterrupt

        try:
            signal.signal(signal.SIGINT, _route)
        except ValueError:
            pass  # not the main thread (embedded/test use): keep default

    # ------------------------------------------------------------------

    def run(self):
        while True:
            try:
                msg = recv_msg(self.chan)
            except KeyboardInterrupt:
                # a cancel SIGINT that raced past its task (the task
                # finished first): ignore — the worker stays in the pool
                continue
            except Exception:  # raylet gone -> exit
                return
            kind = msg.get("type")
            if kind == "task":
                self._execute(msg["task"])
                self._send({"type": "task_done",
                            "task_id": msg["task"].get("task_id")})
            elif kind == "create_actor":
                self._create_actor(msg["actor_id"], msg["task"],
                                   msg.get("incarnation", 0))
            elif kind == "actor_task":
                self._enqueue_actor_task(msg["task"])
            elif kind == "cancel_push":
                self._cancel_push(msg["task_id"])
            elif kind == "lease_granted":
                self._arm_lease_watch()
            elif kind == "exit":
                return

    def _send(self, msg: dict):
        try:
            send_msg(self.chan, msg, self.chan_lock)
        except OSError:
            os._exit(1)

    # ------------------------------------------------------------------
    # argument / result plumbing
    # ------------------------------------------------------------------

    _EMPTY_ARGS_BLOB = serialization.dumps(([], {}))

    def _resolve_args(self, task: dict):
        if task["args_blob"] == self._EMPTY_ARGS_BLOB:
            # no-arg calls dominate microbench/fan-out loads: skip the
            # per-task unpickle (and the marker scan) entirely
            return [], {}
        epoch0 = (self._refs.created_epoch() if self._ref_enabled else 0)
        args, kwargs = serialization.loads(task["args_blob"])
        dep_oids = [a[1] for a in _iter_markers(args, kwargs)]
        # Results of EARLIER tasks in the SAME pushed batch live only in
        # the batch's direct-return sink: the reply that publishes them
        # to the owner cannot be sent until this very task finishes, so
        # asking the raylet (ensure_local) for them deadlocks the whole
        # lease pipeline for the full dependency timeout. Resolve those
        # straight from the sink; pull everything else as usual.
        sink = task.get("_direct_sink") or {}
        values = {}
        pull = []
        for oid_hex in dep_oids:
            payload = sink.get(oid_hex)
            if payload is None:
                pull.append(oid_hex)
            elif oid_hex not in values:
                value, is_error = object_codec.decode_view(
                    memoryview(payload).cast("B"))
                if is_error:
                    raise value
                values[oid_hex] = value
        if pull:
            # bounded client wait: a lost reply on a live control channel
            # must not hang the worker forever
            try:
                missing = self.ctrl.call("ensure_local", oids=pull,
                                         timeout_s=60.0, timeout=65.0)
            except TimeoutError:
                missing = pull
            if missing:
                raise exc.ObjectLostError(missing[0], "dependency not found")
        for _, oid_hex in _iter_markers(args, kwargs):
            if oid_hex in values:
                continue
            value, is_error = object_codec.get_value(
                self.store, bytes.fromhex(oid_hex), timeout_ms=0)
            if is_error:
                raise value
            values[oid_hex] = value
        args = [values[a[1]] if _is_marker(a) else a for a in args]
        kwargs = {k: values[v[1]] if _is_marker(v) else v
                  for k, v in kwargs.items()}
        if self._ref_enabled and self._refs.created_epoch() != epoch0:
            # args carried nested ObjectRefs: register this process's
            # holds BEFORE execution so they are live at the GCS while
            # the submitter's task pin is still in place
            self._ref_flush_now()
        return args, kwargs

    def _ref_flush_loop(self):
        import time as _time

        from ray_tpu_torch.utils.config import get_config

        period = get_config().ref_heartbeat_interval_s
        last_beat = _time.monotonic()
        while True:
            # event-driven: block until ref activity (or the client-
            # liveness heartbeat is due) instead of polling — thousands
            # of idle workers polling thrash the host scheduler
            remain = period - (_time.monotonic() - last_beat)
            if self._refs.wait_pending(max(remain, 0.05)):
                _time.sleep(0.1)    # coalesce a burst into one RPC
            now = _time.monotonic()
            beat = now - last_beat >= period
            if self._ref_flush_now(force_heartbeat=beat) or beat:
                last_beat = now

    def _ref_flush_now(self, force_heartbeat: bool = False) -> bool:
        from ray_tpu_torch.runtime.refcount import flush_once

        with self._ref_send_lock:
            return flush_once(self._refs, self._gcs.call, self.worker_id,
                              "worker", force_heartbeat)

    def _release_task_pin(self, task: dict):
        """Execution finished: release the submitter's arg pins for this
        task (only when the owner actually registered some)."""
        if self._ref_enabled and task.get("pinned"):
            self._refs.release_task_pin(task.get("task_id", ""))

    def _store_returns(self, task: dict, result):
        if task.get("streaming"):
            # generator task: seal each yield at its derived oid AS IT IS
            # PRODUCED (consumers iterate while this loop still runs),
            # then the count object (= the declared return oid)
            from ray_tpu_torch.runtime.streaming import store_stream

            store_stream(
                result, bytes.fromhex(task["task_id"]),
                lambda oid, v, er: self._put_and_report(oid.hex(), v,
                                                        is_error=er),
                lambda oid, n: self._put_and_report(oid.hex(), n))
            return
        return_oids = task["return_oids"]
        if len(return_oids) == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != len(return_oids):
                raise ValueError(
                    f"task declared {len(return_oids)} returns, got "
                    f"{len(values)}")
        sink = task.get("_direct_sink")
        for oid_hex, value in zip(return_oids, values):
            if sink is not None and self._try_direct_return(
                    sink, oid_hex, value):
                continue
            self._put_and_report(oid_hex, value)

    # returns at or under this encoded size ride the push reply to the
    # owner instead of the local shm store (reference:
    # max_direct_call_object_size — small objects live in the owner's
    # memory store, memory_store.h:43)
    def _try_direct_return(self, sink: dict, oid_hex: str, value,
                           is_error: bool = False) -> bool:
        limit = self._direct_limit
        try:
            payload, obj, caught = object_codec.encode_bytes(
                value, is_error=is_error, limit=limit)
        except Exception:  # noqa: BLE001 - unpicklable: store path errors
            return False
        if payload is None:
            # too large for the reply: shm store path, reusing the
            # serialized form (a 1 GiB return must not pickle twice)
            self._put_and_report(oid_hex, value, is_error=is_error,
                                 preserialized=obj, contained=caught)
            return True
        if caught:
            # the return value contains ObjectRefs: the contains-edges
            # anchor on the return oid (which will materialize at the
            # owner's store)
            self._refs.add_contains(oid_hex, caught)
        sink[oid_hex] = payload
        return True

    def _put_and_report(self, oid_hex: str, value, is_error: bool = False,
                        preserialized=None, contained=None):
        """Put with a held ref, then report so the raylet pins the primary
        copy. The seal-HOLD stays live until the (batched) report flush
        confirms the pin — never a window in which the sealed object is
        evictable (reference: plasma seal + raylet PinObjectIDs in the
        task-return handshake). Reports are BATCHED across task returns:
        one raylet RPC per flush instead of per return keeps the control
        round trip off the task hot path."""
        oid = bytes.fromhex(oid_hex)
        size = object_codec.put_value_durable(
            self.store, oid, value, is_error=is_error,
            request_space=self._request_space, hold=True,
            preserialized=preserialized, contained=contained)
        with self._report_cv:
            self._report_buf.append((oid_hex, size))
            self._report_cv.notify()

    def _report_flush_loop(self):
        import time as _time

        while True:
            with self._report_cv:
                while not self._report_buf:
                    self._report_cv.wait()
            _time.sleep(self._report_linger_s)  # coalesce return burst
            with self._report_cv:
                batch, self._report_buf = self._report_buf, []
            try:
                # one token per batch: if the reply is lost and a retry
                # layer redelivers, the raylet pins each object once
                import uuid as _uuid

                self.ctrl.call("report_objects",
                               entries=[(o, s) for o, s in batch],
                               token=_uuid.uuid4().hex)
            except Exception:  # noqa: BLE001 - raylet gone; exiting soon
                pass
            finally:
                for oid_hex, size in batch:
                    if size > 0:   # size 0 = lost first-write race: no hold
                        try:
                            self.store.release(bytes.fromhex(oid_hex))
                        except Exception:  # noqa: BLE001
                            pass

    def _request_space(self, nbytes: int):
        self.ctrl.call("request_space", nbytes=nbytes)

    def _store_error(self, task: dict, error: BaseException):
        sink = task.get("_direct_sink")
        for oid_hex in task["return_oids"]:
            oid = bytes.fromhex(oid_hex)
            if self.store.contains(oid):
                continue
            if sink is not None and self._try_direct_return(
                    sink, oid_hex, error, is_error=True):
                continue
            try:
                self._put_and_report(oid_hex, error, is_error=True)
            except Exception:  # noqa: BLE001 - unpicklable exception
                self._put_and_report(
                    oid_hex,
                    exc.TaskError(task.get("name", "?"),
                                  RuntimeError(repr(error))),
                    is_error=True)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _report_task_event(self, task: dict, start: float, ok: bool):
        """Buffered task-event reporting to the GCS sink (reference:
        task_event_buffer.cc -> gcs_task_manager.cc). Flushes every few
        events so the GCS's task-event table sees cluster tasks
        without a per-task RPC."""
        import os as _os
        import time as _time

        # start is this process's monotonic clock; wall_* re-anchors the
        # pair to wall time before the event leaves the process, so the
        # GCS sink holds cross-worker-comparable stamps (and the unified
        # chrome trace can overlay them with wall-clock tracing spans)
        end = _time.monotonic()
        wall_end = _time.time()
        with self._event_lock:
            self._event_buf.append({
                "task_id": task.get("task_id", ""),
                "name": task.get("name", "?"),
                "start": start,
                "end": end,
                "wall_start": wall_end - (end - start),
                "wall_end": wall_end,
                "pid": _os.getpid(),
                "state": "FINISHED" if ok else "FAILED",
                "thread": f"worker-{self.worker_id[:8]}",
            })
            # large batch threshold (flag task_event_batch_size): at
            # 10k+ calls/s a flush-per-8 means >1k GCS RPCs/s of pure
            # observability; the timer flusher bounds staleness for
            # sparse workloads
            full = len(self._event_buf) >= self._event_batch
        if full or _time.monotonic() - self._last_flush > \
                self._event_flush_s:
            self._flush_task_events()

    def _flush_loop(self):
        import time as _time

        while True:
            _time.sleep(1.0)
            self._flush_task_events()

    def _flush_task_events(self):
        import time as _time

        with self._event_lock:
            if not self._event_buf:
                return
            batch, self._event_buf = self._event_buf, []
        self._last_flush = _time.monotonic()
        try:
            self._gcs.call("add_task_events", events=batch)
        except (OSError, ConnectionError):
            pass  # observability only; never fail work for it

    def _load_function(self, blob: bytes):
        """Unpickle-once function cache (reference: executors fetch and
        register a function ONCE from the function table —
        ``fetch_and_register_remote_function``); repeated tasks of the
        same function skip the unpickling."""
        key = hash(blob)
        hit = self._fn_cache.get(key)
        if hit is not None and hit[0] == blob:
            return hit[1]
        fn = serialization.loads(blob)
        if len(self._fn_cache) > self._fn_cache_cap:
            self._fn_cache.clear()
        self._fn_cache[key] = (blob, fn)
        return fn

    def _load_function_id(self, fn_id: str):
        """Function-TABLE path: the task carries a 16-byte content id;
        the blob is fetched from the GCS table once per (worker,
        function) and cached by id (content-addressed — no blob compare
        needed on hits)."""
        hit = self._fn_id_cache.get(fn_id)
        if hit is not None:
            return hit
        blob = self._gcs.call("kv_get", ns="__functions__", key=fn_id)
        if blob is None:
            raise exc.TaskError(
                "?", RuntimeError(f"function {fn_id} not in the GCS "
                                  f"function table"))
        fn = serialization.loads(blob)
        if len(self._fn_id_cache) > self._fn_cache_cap:
            self._fn_id_cache.clear()
        self._fn_id_cache[fn_id] = fn
        return fn

    def _execute(self, task: dict):
        from ray_tpu_torch.runtime_context import (reset_task_namespace,
                                             set_task_namespace)

        ns_token = set_task_namespace(task.get("namespace"))
        try:
            self._execute_inner(task)
        finally:
            reset_task_namespace(ns_token)
            self._release_task_pin(task)

    def _execute_inner(self, task: dict):
        import time as _time

        started = _time.monotonic()
        try:
            if "function_ref" in task:
                # cross-language task (C++/external client): the function
                # is a DESCRIPTOR resolved by import, args are plain data
                # already decoded from the msgpack frame (runtime/xlang.py
                # — reference: cross-language function descriptors)
                from ray_tpu_torch.runtime.xlang import resolve_function_ref

                fn = resolve_function_ref(task["function_ref"])
                args = list(task.get("args") or [])
                kwargs = dict(task.get("kwargs") or {})
            elif "function_id" in task:
                fn = self._load_function_id(task["function_id"])
                args, kwargs = self._resolve_args(task)
            else:
                fn = self._load_function(task["function_blob"])
                args, kwargs = self._resolve_args(task)
        except BaseException as e:  # noqa: BLE001
            self._store_error(task, e)
            self._report_task_event(task, started, False)
            return
        try:
            from ray_tpu_torch.runtime import fault_injection as _fi

            # crash point: args resolved, function loaded, mid-execution
            # — the owner's lease channel breaks with no reply and the
            # retry/typed-error path must cover it (chaos worker class)
            _fi.maybe_crash("worker.mid_task")
            result = fn(*args, **kwargs)
            if _iscoroutine(result):
                # async def remote function: drive it to completion
                # on a per-task loop (reference: async tasks run on
                # the worker's event loop)
                import asyncio

                result = asyncio.run(result)
        except BaseException as e:  # noqa: BLE001
            self._store_error(
                task, exc.TaskError(task.get("name", "?"), e,
                                    tb=traceback.format_exc()))
            self._report_task_event(task, started, False)
            return
        try:
            self._store_returns(task, result)
        except BaseException as e:  # noqa: BLE001
            self._store_error(task, e)
            self._report_task_event(task, started, False)
            return
        self._report_task_event(task, started, True)

    def _create_actor(self, actor_id: str, task: dict,
                      incarnation: int = 0):
        try:
            cls = serialization.loads(task["function_blob"])
            # the actor lives in its creator's namespace: every method
            # execution (and nested get_actor/create_actor from methods)
            # resolves names there
            self.actor_namespace = task.get("namespace")
            from ray_tpu_torch.runtime_context import (set_actor_namespace,
                                                       set_task_namespace)

            set_task_namespace(self.actor_namespace)
            set_actor_namespace(self.actor_namespace)
            args, kwargs = self._resolve_args(task)
            self.actor_instance = cls(*args, **kwargs)
            self.actor_id = actor_id
            self.actor_incarnation = incarnation
            import inspect

            if any(inspect.iscoroutinefunction(getattr(cls, n, None))
                   for n in dir(cls)):
                # ASYNC actor: methods are scheduled onto this loop (the
                # executor thread posts, never waits), so awaits overlap
                # up to max_concurrency in-flight calls
                import asyncio

                self._actor_loop = asyncio.new_event_loop()
                self._actor_sem = asyncio.Semaphore(
                    max(1, int(task.get("max_concurrency") or 1)))
                threading.Thread(target=self._actor_loop.run_forever,
                                 daemon=True,
                                 name="actor-asyncio-loop").start()
            if not self._actor_exec_started:
                self._actor_exec_started = True
                threading.Thread(target=self._actor_exec_loop,
                                 daemon=True,
                                 name="actor-executor").start()
        except BaseException as e:  # noqa: BLE001
            self._send({"type": "actor_creation_failed",
                        "actor_id": actor_id,
                        "reason": f"{type(e).__name__}: {e}"})
            self._store_error(task, exc.ActorDiedError(
                actor_id, f"__init__ failed: {e!r}"))
            self._release_task_pin(task)
            self._ref_flush_now()   # the pin release must outrun os._exit
            self._send({"type": "task_done", "task_id": task.get("task_id")})
            os._exit(1)
        self._release_task_pin(task)
        self._store_returns(task, None)
        self._send({"type": "actor_ready", "actor_id": actor_id})
        self._send({"type": "task_done", "task_id": task.get("task_id")})

    def _enqueue_actor_task(self, task: dict):
        """Per-caller submission-order execution (sequence buffering)."""
        caller = task.get("caller_id", "?")
        seq = task.get("seq", 0)
        runnable = []
        with self._seq_lock:
            if seq < self._next_seq[caller]:
                # duplicate delivery (caller retried after a lost reply):
                # the original execution already sealed the return objects
                # (first-write-wins), so drop instead of re-running
                return
            self._seq_buffer[caller][seq] = task
            while self._next_seq[caller] in self._seq_buffer[caller]:
                t = self._seq_buffer[caller].pop(self._next_seq[caller])
                self._next_seq[caller] += 1
                runnable.append(t)
        for t in runnable:
            self._actor_exec_q.put(t)

    def _actor_exec_loop(self):
        from ray_tpu_torch.runtime_context import set_task_namespace

        while True:
            task = self._actor_exec_q.get()
            # per-thread contextvar: the creator's namespace must be set
            # HERE (and is captured by run_coroutine_threadsafe for async
            # calls), not just on the channel thread that created the
            # actor
            set_task_namespace(getattr(self, "actor_namespace", None))
            try:
                if self._actor_loop is not None and not task.get("noop"):
                    self._post_async_actor_task(task)
                else:
                    self._run_actor_task(task)
            except BaseException:  # noqa: BLE001
                # _run_actor_task seals task errors itself; anything that
                # still escapes would silently kill this (sole) executor
                # thread and turn every future call into an acked-then-
                # queued-forever hang. Crash the worker instead — the
                # raylet's death path restarts the actor (the pre-
                # executor-thread behavior).
                traceback.print_exc()
                os._exit(1)

    def _post_async_actor_task(self, task: dict):
        """Async-actor dispatch: resolve args on THIS thread (dependency
        pulls are blocking control RPCs that must not stall the event
        loop), then fire the call onto the loop and move to the next
        queued task — calls START in per-caller submission order and
        interleave at await points (reference async-actor semantics)."""
        import asyncio
        import time as _time

        started = _time.monotonic()
        try:
            args, kwargs = self._resolve_args(task)
        except BaseException as e:  # noqa: BLE001
            self._store_error(
                task, exc.TaskError(task.get("name", "?"), e,
                                    tb=traceback.format_exc()))
            self._report_task_event(task, started, False)
            self._release_task_pin(task)
            if not task.get("_direct"):
                self._send({"type": "task_done",
                            "task_id": task.get("task_id")})
            return
        asyncio.run_coroutine_threadsafe(
            self._run_actor_coro(task, args, kwargs), self._actor_loop)

    async def _run_actor_coro(self, task: dict, args, kwargs):
        """One async-actor call, bounded by the concurrency semaphore.
        Sync methods of an async actor run inline ON the loop (they
        block it — reference behavior: everything posts to the loop)."""
        import inspect
        import time as _time

        async with self._actor_sem:
            started = _time.monotonic()
            _done = (lambda: None) if task.get("_direct") else (
                lambda: self._send({"type": "task_done",
                                    "task_id": task.get("task_id")}))

            def done():
                self._release_task_pin(task)
                _done()
            try:
                method = getattr(self.actor_instance,
                                 task["method_name"])
                result = method(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
            except BaseException as e:  # noqa: BLE001
                self._store_error(
                    task, exc.TaskError(task.get("name", "?"), e,
                                        tb=traceback.format_exc()))
                self._report_task_event(task, started, False)
                done()
                return
            try:
                self._store_returns(task, result)
            except BaseException as e:  # noqa: BLE001
                self._store_error(task, e)
                self._report_task_event(task, started, False)
                done()
                return
            self._report_task_event(task, started, True)
            done()

    def _run_actor_task(self, task: dict):
        import time as _time

        # direct-pushed tasks (owner -> this worker, no raylet hop) need
        # no task_done: the raylet tracked nothing for them, and at 10k+
        # calls/s the per-call frame to the raylet channel is pure GIL
        # and syscall overhead on both ends
        _done = (lambda: None) if task.get("_direct") else (
            lambda: self._send({"type": "task_done",
                                "task_id": task.get("task_id")}))

        def done():
            self._release_task_pin(task)
            _done()
        if task.get("noop"):
            # seq gap-filler (owner sealed errors for a submit that never
            # arrived): advances the ordered queue, executes nothing
            done()
            return
        started = _time.monotonic()
        try:
            from ray_tpu_torch.runtime import fault_injection as _fi

            args, kwargs = self._resolve_args(task)
            method = getattr(self.actor_instance, task["method_name"])
            # crash point: actor method about to run — exercises the
            # actor RESTARTING/DEAD reconciliation + typed
            # ActorDiedError surfacing at the caller
            _fi.maybe_crash("worker.mid_actor_task")
            result = method(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            self._store_error(
                task, exc.TaskError(task.get("name", "?"), e,
                                    tb=traceback.format_exc()))
            self._report_task_event(task, started, False)
            done()
            return
        try:
            self._store_returns(task, result)
        except BaseException as e:  # noqa: BLE001
            self._store_error(task, e)
            self._report_task_event(task, started, False)
            done()
            return
        self._report_task_event(task, started, True)
        done()


def _iscoroutine(x) -> bool:
    import inspect

    return inspect.iscoroutine(x)


def _is_marker(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and x[0] == "__objref__")


def _iter_markers(args, kwargs):
    for a in args:
        if _is_marker(a):
            yield a
    for v in kwargs.values():
        if _is_marker(v):
            yield v


def main():
    import sys

    if "--zygote" in sys.argv[1:]:
        # fork-server template mode (runtime/prestart.py): preload the
        # worker import set once, then serve os.fork() requests over the
        # control pipe — each forked child re-enters Worker().run() with
        # a fresh identity. The template itself NEVER constructs a
        # Worker and never initializes CUDA (a forked child of a process
        # holding a CUDA context cannot use the card; the card attaches
        # post-fork in the child).
        from ray_tpu_torch.runtime.prestart import zygote_main

        raise SystemExit(zygote_main())
    Worker().run()


if __name__ == "__main__":
    main()
