"""Minimal threaded RPC over TCP: length-prefixed pickled messages.

Port of ``ray_tpu/runtime/rpc.py`` with its fault-injection plane
(``runtime/fault_injection.py``: every server and client consults it on
connect, send and receive), without the per-method handler timers and the
trace headers (the observability planes are a later slice); the framing is
the same, so the framed bytes equal the
JAX package's for the same message. Reference analog: ``src/ray/rpc/``
(async gRPC server/client templates).
Wire format: 8-byte big-endian length + pickled payload. Two interaction
shapes, mirroring the reference's usage:

- request/response: ``RpcClient.call(method, **kwargs)`` — blocking, safe
  from many threads (per-call matching via request ids).
- server push: a connection can be promoted to a push channel (pubsub long
  poll analog, ``src/ray/pubsub/``) — the server holds it and writes
  messages; the client runs a reader thread delivering to a callback.

All services in the cluster plane (GCS, raylet) are ``RpcServer`` subclasses
exposing ``rpc_<method>`` handlers; handlers run on a thread per connection.
"""

from __future__ import annotations

import pickle
import random
import socket
import struct
import threading
import time
from typing import Any, Callable

from ray_tpu_torch.runtime import fault_injection as _fi

_LEN = struct.Struct(">Q")


class ConnectionLost(Exception):
    pass


# Cross-language frames: a payload starting with b"M" is msgpack (the
# C++ client's wire — see runtime/xlang.py); pickled payloads start with
# the PROTO opcode 0x80, so the marker never collides. Servers answer
# each request in the format it arrived in.
_MSGPACK_MARK = 0x4D  # "M"


def send_msg(sock: socket.socket, obj: Any,
             lock: threading.Lock | None = None, fmt: str = "pickle"):
    if fmt == "msgpack":
        from ray_tpu_torch.runtime import xlang

        if isinstance(obj, dict) and isinstance(obj.get("error"),
                                                BaseException):
            # exceptions don't cross the language boundary as objects
            obj = {**obj, "error": repr(obj["error"])}
        data = bytes((_MSGPACK_MARK,)) + xlang.dumps(obj)
    else:
        data = pickle.dumps(obj, protocol=5)
    frame = _LEN.pack(len(data)) + data
    if lock:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_msg(sock: socket.socket) -> Any:
    return recv_msg_any(sock)[0]


def recv_msg_any(sock: socket.socket) -> tuple[Any, str]:
    """Receive one frame, returning (message, format)."""
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    payload = _recv_exact(sock, length)
    if payload and payload[0] == _MSGPACK_MARK:
        from ray_tpu_torch.runtime import xlang

        return xlang.loads(payload[1:]), "msgpack"
    return pickle.loads(payload), "pickle"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionLost("peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class RpcServer:
    """Threaded TCP server; dispatches ``{"method": m, ...}`` requests to
    ``self.rpc_<m>(conn, **payload)``. A handler may return
    ``HELD`` to take ownership of the connection (push channels)."""

    HELD = object()

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(256)
        self.address = self._sock.getsockname()
        self._stopping = False
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # endpoint label for the fault-injection plane (subclasses set a
        # role name: "gcs", "raylet", "worker")
        self.fault_label = type(self).__name__
        # handlers running now: stop() severs their connections, but a
        # handler mid-call runs on; wait_idle lets an owner outlive them
        # before it frees what they touch
        self._running = 0
        self._running_cv = threading.Condition()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{type(self).__name__}-accept",
            daemon=True,
        )

    def start(self):
        self._accept_thread.start()
        return self

    def stop(self):
        self._stopping = True
        # Wake the accept thread and JOIN it BEFORE closing the listener:
        # close() frees the fd NUMBER for the kernel to reuse, and a
        # thread still parked in (or retrying) accept() on that number
        # would accept on whatever socket inherits it — observed stealing
        # a freshly-bound server's connections in back-to-back test
        # clusters and closing them (spurious ConnectionLost on clients
        # of the NEW server). shutdown() makes the parked accept return
        # EINVAL deterministically.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass
        # sever live connections: a stopped server must not keep accepting
        # work over held sockets — peers would get "ok" replies for
        # requests that silently black-hole (e.g. a task enqueued on a
        # raylet whose dispatch loop is gone)
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def wait_idle(self, timeout: float) -> bool:
        """Wait up to ``timeout`` for every running handler to return
        (after ``stop()``: the port's raylet closes its shared-memory store
        only then, as a handler still inside the store would touch an
        unmapped segment). A held channel's handler returns when its peer
        goes. Returns whether none is left."""
        deadline = time.monotonic() + timeout
        with self._running_cv:
            while self._running:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._running_cv.wait(remain)
        return True

    def _accept_loop(self):
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._stopping:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def release_conn(self, conn: socket.socket):
        """Drop a HELD connection from the severing set once its owner is
        done with it (held-handler finally blocks / publisher dead-sub
        cleanup). Prevents dead sockets accumulating in _conns."""
        with self._conns_lock:
            self._conns.discard(conn)

    def _serve_conn(self, conn: socket.socket):
        send_lock = threading.Lock()
        held = False
        fmt = "pickle"
        try:
            while not self._stopping:
                try:
                    req, fmt = recv_msg_any(conn)
                except (ConnectionLost, OSError, EOFError):
                    return
                if self._stopping:
                    # request raced the shutdown: error instead of
                    # half-processing on a dying service
                    try:
                        send_msg(conn, {"_id": req.get("_id"),
                                        "error": ConnectionLost(
                                            "server stopping")}, send_lock,
                                 fmt=fmt)
                    except (OSError, Exception):  # noqa: BLE001
                        pass
                    return
                req_id = req.pop("_id", None)
                method = req.pop("method")
                deliveries = 1
                if _fi.plane.active:
                    try:
                        peer = conn.getpeername()
                    except OSError:
                        peer = ("?", 0)
                    action = _fi.plane.consult(self.fault_label, "recv",
                                               peer, method)
                    if action == _fi.DROP:
                        continue   # request lost before dispatch
                    if action == _fi.RESET:
                        return     # finally: discard + on_disconnect
                    if action == _fi.DUPLICATE:
                        deliveries = 2
                for delivery in range(deliveries):
                    # an injected duplicate re-dispatches from a fresh
                    # deserialization — handlers may mutate their payload
                    payload = (req if delivery == deliveries - 1
                               else pickle.loads(pickle.dumps(req)))
                    outcome = self._dispatch_one(conn, send_lock, fmt,
                                                 method, req_id, payload)
                    if outcome == "held":
                        held = True
                        return
                    if outcome == "gone":
                        return
        finally:
            if not held:
                with self._conns_lock:
                    self._conns.discard(conn)
            if not self._stopping:
                self.on_disconnect(conn)

    def _dispatch_one(self, conn, send_lock, fmt, method, req_id,
                      payload) -> str:
        """Dispatch one request and send its reply. Returns "ok", "held"
        (handler took the connection), or "gone" (peer unreachable)."""
        handler = getattr(self, f"rpc_{method}", None)
        try:
            if handler is None:
                raise AttributeError(f"no rpc method {method!r}")
            with self._running_cv:
                self._running += 1
            try:
                result = handler(conn, send_lock, **payload)
            finally:
                with self._running_cv:
                    self._running -= 1
                    self._running_cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - ship to caller
            try:
                self._send_reply(conn, {"_id": req_id, "error": e},
                                 send_lock, fmt, method)
            except OSError:
                return "gone"  # peer gone; nothing to reply to
            except Exception:  # unpicklable exception payload
                try:
                    self._send_reply(conn,
                                     {"_id": req_id,
                                      "error": RuntimeError(repr(e))},
                                     send_lock, fmt, method)
                except OSError:
                    return "gone"
            return "ok"
        if result is RpcServer.HELD:
            # handler owns the connection; it STAYS in _conns so
            # stop() can sever it — the owner calls release_conn
            # when the channel is truly finished
            return "held"
        try:
            self._send_reply(conn, {"_id": req_id, "result": result},
                             send_lock, fmt, method)
        except OSError:
            return "gone"  # peer closed mid-reply (e.g. returned lease)
        except Exception as e:  # noqa: BLE001 - unencodable result
            try:
                self._send_reply(conn, {"_id": req_id,
                                        "error": RuntimeError(repr(e))},
                                 send_lock, fmt, method)
            except OSError:
                return "gone"
        return "ok"

    def _send_reply(self, conn, obj, send_lock, fmt, method):
        if _fi.plane.active:
            try:
                peer = conn.getpeername()
            except OSError:
                peer = ("?", 0)
            action = _fi.plane.consult(self.fault_label, "send", peer,
                                       method)
            if action == _fi.DROP:
                return   # reply lost in flight (handler still applied)
            if action == _fi.RESET:
                raise _fi.InjectedConnectionReset(
                    f"injected reset replying to {method}")
            send_msg(conn, obj, send_lock, fmt=fmt)
            if action == _fi.DUPLICATE:
                send_msg(conn, obj, send_lock, fmt=fmt)
            return
        send_msg(conn, obj, send_lock, fmt=fmt)

    def on_disconnect(self, conn: socket.socket):
        """Override: called when a non-held connection drops."""


class RpcClient:
    """Blocking request/response client, thread-safe, auto-reconnect off."""

    def __init__(self, address: tuple[str, int], timeout: float | None = None,
                 label: str | None = None):
        self.address = tuple(address)
        self._label = label   # fault-injection endpoint of the channel
        if _fi.plane.active:
            _fi.plane.check_connect(label, self.address)
        self._sock = socket.create_connection(self.address, timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(timeout)
        self._send_lock = threading.Lock()
        self._pending: dict[int, list] = {}  # id -> [event, reply, method]
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._reader_started = False
        self._closed = False

    def _ensure_reader(self):
        # guarded: a cached client is shared across threads, and two
        # racing readers interleaving framed reads corrupt the stream
        with self._pending_lock:
            if self._reader_started:
                return
            self._reader_started = True
        threading.Thread(target=self._read_loop, daemon=True).start()

    def _read_loop(self):
        while not self._closed:
            try:
                msg = recv_msg(self._sock)
            except (ConnectionLost, OSError, EOFError):
                self._fail_pending()
                return
            msg_id = msg.get("_id")
            if _fi.plane.active:
                with self._pending_lock:
                    entry = self._pending.get(msg_id)
                method = entry[2] if entry else None
                action = _fi.plane.consult(self._label, "recv",
                                           self.address, method)
                if action == _fi.DROP:
                    continue   # reply lost in flight; caller times out
                if action == _fi.RESET:
                    self._fail_pending()
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    return
                # a duplicated reply delivery is inert: the pending
                # entry is popped exactly once below
            with self._pending_lock:
                ev_reply = self._pending.pop(msg_id, None)
            if ev_reply is not None:
                ev_reply[1] = msg
                ev_reply[0].set()

    def _fail_pending(self):
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
            self._closed = True
        # release the fd NOW: a client whose peer was SIGKILLed sits in
        # per-address caches as a dead entry until eviction, and a
        # fault-churned cluster (chaos soak) leaks one fd per killed
        # peer otherwise
        try:
            self._sock.close()
        except OSError:
            pass
        for ev_reply in pending:
            ev_reply[1] = {"error": ConnectionLost(
                f"connection to {self.address} lost")}
            ev_reply[0].set()

    def call(self, method: str, timeout: float | None = None, **kwargs):
        return self.call_async(method, **kwargs).result(timeout=timeout)

    def call_async(self, method: str, **kwargs) -> "PendingCall":
        """Send the request and return a handle; multiple in-flight calls
        pipeline over the one connection (the server processes a
        connection's requests in order, so pipelining hides the caller's
        round-trip latency without reordering)."""
        self._ensure_reader()
        with self._pending_lock:
            # _closed must be re-checked INSIDE the lock: the reader's
            # failure path drains _pending and sets _closed under this
            # lock, and an entry registered after that drain would never
            # be completed (permanent hang for timeout=None callers)
            if self._closed:
                raise ConnectionLost(f"client to {self.address} closed")
            msg_id = self._next_id
            self._next_id += 1
            ev_reply = [threading.Event(), None, method]
            self._pending[msg_id] = ev_reply
        kwargs["method"] = method
        kwargs["_id"] = msg_id
        if _fi.plane.active:
            action = _fi.plane.consult(self._label, "send", self.address,
                                       method)
            if action == _fi.DROP:
                # request lost in the network: the pending entry waits
                # out the caller's timeout, as a real drop would
                return PendingCall(self, method, msg_id, ev_reply)
            if action == _fi.RESET:
                self.close()   # reader wakes and drains pending
                raise ConnectionLost(
                    f"injected reset: {self._label} -> {self.address}")
            send_msg(self._sock, kwargs, self._send_lock)
            if action == _fi.DUPLICATE:
                # same frame (same _id) on the wire twice: the server
                # dispatches both; the client keeps the first reply
                send_msg(self._sock, kwargs, self._send_lock)
            return PendingCall(self, method, msg_id, ev_reply)
        send_msg(self._sock, kwargs, self._send_lock)
        return PendingCall(self, method, msg_id, ev_reply)

    def close(self):
        self._closed = True
        try:
            # shutdown() WAKES a reader thread blocked in recv();
            # close() alone leaves it blocked forever (the classic
            # transient-client thread leak)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class ReconnectingRpcClient:
    """RpcClient wrapper that redials after connection loss — the client
    side of control-plane fault tolerance (reference: GCS clients retry
    through ``gcs_rpc_client.h`` when the GCS restarts). One transparent
    retry per call after a successful redial; GCS mutations are
    idempotent (registry upserts + idempotency tokens on the
    side-effecting RPCs), so a request that was applied right before the
    connection died is safe to repeat.

    Redials run under a UNIFORM deadline with exponential backoff plus
    jitter and a bounded attempt budget (config ``rpc_redial_*`` /
    ``rpc_backoff_*``): a per-call ``timeout`` caps the redial window
    too, so a caller's deadline covers the whole call including
    reconnects — not a fresh window per attempt."""

    def __init__(self, address: tuple, timeout: float | None = None,
                 redial_window_s: float | None = None,
                 label: str | None = None):
        from ray_tpu_torch.utils.config import get_config

        cfg = get_config()
        self.address = tuple(address)
        self._timeout = timeout
        self._label = label
        self._window = (cfg.rpc_redial_window_s if redial_window_s is None
                        else redial_window_s)
        self._max_redials = cfg.rpc_redial_max_attempts
        self._backoff_init = cfg.rpc_backoff_initial_s
        self._backoff_mult = cfg.rpc_backoff_multiplier
        self._backoff_max = cfg.rpc_backoff_max_s
        self._jitter = cfg.rpc_backoff_jitter
        self._client = RpcClient(self.address, timeout=timeout,
                                 label=label)
        self._dial_lock = threading.Lock()

    @property
    def _closed(self):
        return self._client._closed

    def _backoff(self, attempt: int) -> float:
        """Exponential backoff with jitter: attempt 1 sleeps ~initial,
        doubling (by multiplier) to the cap; jitter desynchronizes a
        thundering herd of clients redialing one restarted server."""
        delay = min(self._backoff_max,
                    self._backoff_init * self._backoff_mult ** (attempt - 1))
        if self._jitter:
            delay *= 1.0 + self._jitter * (2.0 * random.random() - 1.0)
        return max(delay, 0.0)

    def _redial(self, failed: RpcClient,
                deadline: float | None = None) -> bool:
        window_end = time.monotonic() + self._window
        if deadline is not None:
            window_end = min(window_end, deadline)
        with self._dial_lock:
            # compare against the CLIENT THAT FAILED, not _closed: a send
            # error can precede the reader thread marking the client
            # closed, and trusting _closed would "retry" on the same dead
            # socket
            if self._client is not failed and not self._client._closed:
                return True  # another caller already reconnected
            failed.close()
            attempt = 0
            while True:
                attempt += 1
                if self._max_redials and attempt > self._max_redials:
                    return False   # redial budget exhausted
                try:
                    self._client = RpcClient(self.address,
                                             timeout=self._timeout,
                                             label=self._label)
                    return True
                except OSError:
                    delay = self._backoff(attempt)
                    if time.monotonic() + delay >= window_end:
                        return False
                    time.sleep(delay)

    def call(self, method: str, timeout: float | None = None, **kwargs):
        deadline = None if timeout is None else time.monotonic() + timeout
        client = self._client
        try:
            return client.call(method, timeout=timeout, **kwargs)
        except (ConnectionLost, OSError):
            if not self._redial(client, deadline):
                raise
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.001))
            return self._client.call(method, timeout=remaining, **kwargs)

    def call_async(self, method: str, **kwargs):
        client = self._client
        try:
            return client.call_async(method, **kwargs)
        except (ConnectionLost, OSError):
            if not self._redial(client):
                raise
            return self._client.call_async(method, **kwargs)

    def close(self):
        self._client.close()


class PendingCall:
    """Handle for an in-flight pipelined request."""

    __slots__ = ("_client", "_method", "_msg_id", "_ev_reply")

    def __init__(self, client: RpcClient, method: str, msg_id: int,
                 ev_reply: list):
        self._client = client
        self._method = method
        self._msg_id = msg_id
        self._ev_reply = ev_reply

    def result(self, timeout: float | None = None):
        if not self._ev_reply[0].wait(timeout=timeout):
            with self._client._pending_lock:
                self._client._pending.pop(self._msg_id, None)
            raise TimeoutError(
                f"rpc {self._method} timed out after {timeout}s")
        reply = self._ev_reply[1]
        if "error" in reply:
            raise reply["error"]
        return reply["result"]


class PushSubscriber:
    """Client side of a server-push channel (pubsub subscribe).

    ``reconnect=True`` redials and re-subscribes after a dropped
    connection (e.g. a GCS restart) — messages published while
    disconnected are lost, matching pubsub semantics."""

    def __init__(self, address: tuple[str, int], subscribe_msg: dict,
                 callback: Callable[[Any], None], *,
                 reconnect: bool = False,
                 reconnect_delay_s: float = 1.0,
                 label: str | None = None, name: str | None = None):
        self._address = tuple(address)
        self._subscribe_msg = subscribe_msg
        self._callback = callback
        self._reconnect = reconnect
        self._reconnect_delay_s = reconnect_delay_s
        self._label = label
        self._closed = False
        self._sock = self._dial()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _dial(self):
        if _fi.plane.active:
            _fi.plane.check_connect(self._label, self._address)
        sock = socket.create_connection(self._address, timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(sock, self._subscribe_msg)
        return sock

    def _loop(self):
        while not self._closed:
            try:
                msg = recv_msg(self._sock)
                if _fi.plane.active:
                    action = _fi.plane.consult(self._label, "recv",
                                               self._address, None)
                    if action == _fi.DROP:
                        continue   # pushed message lost (pubsub allows)
                    if action == _fi.RESET:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        raise ConnectionLost("injected reset")
            except (ConnectionLost, OSError, EOFError):
                if not self._reconnect or self._closed:
                    return
                time.sleep(self._reconnect_delay_s)
                try:
                    self._sock = self._dial()
                except OSError:
                    continue   # server still down; retry next round
                continue
            try:
                self._callback(msg)
            except Exception:  # noqa: BLE001 - subscriber errors are isolated
                pass

    def close(self, join_timeout: float | None = None):
        """Close the channel; with ``join_timeout``, also wait for the
        receive thread (and a callback it is running) to end."""
        self._closed = True
        try:
            # wakes a recv blocked on this socket (close alone does not)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if join_timeout is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(join_timeout)


def wait_for_port(address: tuple[str, int], timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(tuple(address), timeout=1):
                return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"server at {address} not reachable")
