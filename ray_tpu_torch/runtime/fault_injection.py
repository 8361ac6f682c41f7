"""Deterministic, config-driven fault-injection plane for the RPC layer.

Port of ``ray_tpu/runtime/fault_injection.py``: the same plan format,
rule engine and seeded per-rule streams, so a plan and a stream of
consults give the same actions in both packages.

Reference analog: the reference's chaos tooling (``python/ray/tests/chaos``
+ the gRPC fault-injection knobs its networking tests lean on). Every
transport primitive in ``runtime/rpc.py`` (``RpcServer``, ``RpcClient``,
``ReconnectingRpcClient``, ``PushSubscriber``) consults the process-global
``plane`` on connect, send, and receive; with no plan loaded the consult
is a single attribute read (``plane.active`` is False).

A *plan* is a dict::

    {"version": 3,              # monotonically increasing; replays ignored
     "seed": 42,                # base seed for probabilistic rules
     "endpoints": {"gcs": ["127.0.0.1:6379"]},   # name -> address list
     "rules": [
        {"id": "cut-gcs", "fault": "partition",
         "src": "driver", "dst": "gcs", "direction": "both"},
        {"fault": "duplicate", "method": "request_lease",
         "src": "raylet", "direction": "recv", "max_hits": 1},
     ]}

Rule fields (all optional except ``fault``):

- ``fault``: ``drop`` | ``delay`` | ``duplicate`` | ``reset`` |
  ``partition`` | ``crash``. ``partition`` severs matching live channels
  AND refuses new connections until the rule is removed (healed); the
  other message faults act per message. ``crash`` is a PROCESS fault:
  it never matches message traffic and instead fires at named *crash
  points* registered throughout the runtime (``maybe_crash("gcs.
  after_wal_append")``) — on the nth seeded hit the host process writes
  a last-words marker line to raw stderr (the worker's ``.err``
  redirect keeps it; supervisors harvest it) and dies via ``os._exit``
  (or SIGKILL with ``signal: "kill"``).
- ``src``: the LOCAL endpoint label of the channel (clients are labeled
  at construction — ``driver``, ``owner``, ``raylet``, ``worker``;
  servers consult with their ``fault_label``). ``*``/absent matches any.
- ``dst``: peer address as ``host:port``, an endpoint NAME resolved
  through the plan's ``endpoints`` map, or ``*``.
- ``direction``: ``send`` | ``recv`` | ``both`` (one-way faults).
- ``method``: RPC method name, or ``*``.
- ``point`` (``crash`` rules): crash-point name or fnmatch pattern
  (``worker.*``). The catalog lives in the JAX package's
  docs/crash_chaos.md; the port registers the same points.
- ``proc`` (``crash`` rules): process role the rule may kill —
  ``gcs`` | ``raylet`` | ``worker`` | ``driver`` | ``*``. Every entry
  point stamps its role on the plane (:func:`set_process_label`); the
  driver-hosted in-process GCS/head raylet keep the ``driver`` label,
  so a ``proc: "raylet"`` rule can only ever kill an external raylet,
  never the test/driver process.
- ``nth`` (fire only on the nth matching call), ``every`` (every nth),
  ``p`` (seeded probability), ``max_hits`` (stop after N injections).
  Counters are per process: a ``crash`` rule with ``nth: 1`` kills each
  matching process at its next hit of the point.
- ``delay_s``: sleep for ``delay`` faults (default 0.05).
- ``signal`` (``crash`` rules): ``exit`` (default, ``os._exit(137)``)
  or ``kill`` (``SIGKILL`` to self — no atexit, no buffered flush
  beyond the already-written marker).

Runtime switching: plans live under the GCS KV key
(``__fault_injection__`` / ``plan``) — the GCS applies writes to its own
process immediately (``rpc_kv_put``), and every other enabled process
polls through :func:`start_kv_watcher`, so a test can open and heal a
partition mid-workload with one ``kv_put``. The watcher's own channel
uses :data:`FAULT_CONTROL_LABEL` and is exempt from injection (a plane
that could partition its own control channel could never heal).

Config flags (``ray_tpu_torch/utils/config.py``, env ``RAY_TPU_FAULT_*``):
``fault_injection_enabled``, ``fault_injection_seed``,
``fault_injection_plan`` (inline JSON or ``@/path/to/plan.json``),
``fault_injection_kv_poll_s``.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from typing import Any

# KV coordinates of the live plan (see GcsServer.rpc_kv_put).
KV_NS = "__fault_injection__"
KV_KEY = "plan"

# Channels carrying fault-plan control traffic are never injected.
FAULT_CONTROL_LABEL = "fault-control"

PASS = "pass"
DROP = "drop"
DELAY = "delay"
DUPLICATE = "duplicate"
RESET = "reset"
PARTITION = "partition"
# Consumed by runtime/prestart.py only (consulted with method
# "fork_worker"): SIGKILL the zygote template right before a fork is
# requested from it, proving the cold-spawn fallback. The RPC layer
# treats it as PASS (it only acts on DROP/DUPLICATE/RESET), so rules
# should pin ``method: "fork_worker"`` to avoid burning hit budgets on
# unrelated messages.
KILL_TEMPLATE = "kill_template"
# Process-crash rule kind: fires at named maybe_crash() points, not on
# message traffic (consult/check_connect skip it entirely).
CRASH = "crash"

_FAULTS = (DROP, DELAY, DUPLICATE, RESET, PARTITION, KILL_TEMPLATE,
           CRASH)

# Last-words marker written to raw fd 2 right before an injected death.
# The worker/raylet ``.err`` redirect keeps it even through SIGKILL;
# supervisors key off this prefix (the worker pool's and the cluster
# supervisor's last-words harvest).
CRASH_MARKER = "RAY_TPU_CRASH"


class InjectedConnectionReset(OSError):
    """Raised on connect into an injected partition (an OSError so every
    existing dial-failure path treats it as an unreachable peer)."""


class _Rule:
    __slots__ = ("rid", "fault", "src", "dst", "direction", "method",
                 "nth", "every", "p", "max_hits", "delay_s",
                 "point", "proc", "signal", "calls", "hits", "rng")

    def __init__(self, spec: dict, index: int, seed: int):
        fault = spec.get("fault")
        if fault not in _FAULTS:
            raise ValueError(f"unknown fault {fault!r} (rule {index})")
        self.rid = str(spec.get("id", f"rule{index}:{fault}"))
        self.fault = fault
        self.src = spec.get("src", "*")
        self.dst = spec.get("dst", "*")
        self.direction = spec.get("direction", "both")
        self.method = spec.get("method", "*")
        self.nth = spec.get("nth")
        self.every = spec.get("every")
        self.p = spec.get("p")
        self.max_hits = spec.get("max_hits")
        self.delay_s = float(spec.get("delay_s", 0.05))
        # crash-rule fields (ignored by message faults)
        self.point = spec.get("point", "*")
        self.proc = spec.get("proc", "*")
        self.signal = spec.get("signal", "exit")
        self.calls = 0
        self.hits = 0
        # per-rule seeded stream: decisions replay exactly for a given
        # (plan seed, rule position, rule id) regardless of other rules
        self.rng = random.Random(f"{seed}:{index}:{self.rid}")

    def matches_point(self, point: str, proc_label: str | None) -> bool:
        if self.proc != "*" and self.proc != proc_label:
            return False
        if self.point == "*" or self.point == point:
            return True
        return fnmatch.fnmatchcase(point, self.point)

    def matches(self, label: str | None, direction: str, peer_key: str,
                method: str | None, endpoints: dict) -> bool:
        if self.src != "*" and self.src != label:
            return False
        if self.direction != "both" and self.direction != direction:
            return False
        if self.method != "*" and self.method != method:
            return False
        if self.dst != "*":
            targets = endpoints.get(self.dst)
            if targets is None:
                targets = (self.dst,)
            if peer_key not in targets:
                return False
        return True

    def fires(self) -> bool:
        """Scheduling predicate; caller holds the plane lock."""
        self.calls += 1
        if self.max_hits is not None and self.hits >= self.max_hits:
            return False
        if self.nth is not None:
            fire = self.calls == self.nth
        elif self.every is not None:
            fire = self.calls % self.every == 0
        elif self.p is not None:
            fire = self.rng.random() < self.p
        else:
            fire = True
        if fire:
            self.hits += 1
        return fire


def _peer_key(peer) -> str:
    if isinstance(peer, str):
        return peer
    try:
        return f"{peer[0]}:{peer[1]}"
    except (TypeError, IndexError):
        return str(peer)


class FaultPlane:
    """Process-global rule engine. ``active`` is the hot-path gate: the
    RPC layer reads it before building any consult arguments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: tuple[_Rule, ...] = ()
        self._endpoints: dict[str, tuple[str, ...]] = {}
        self._seed = 0
        self.version = -1
        self.active = False
        self.stats: dict[str, int] = {}
        # role stamp consulted by crash rules' ``proc`` scoping; set
        # once per process by set_process_label() at the entry point
        self.process_label: str | None = None
        # test seam: a harness may intercept the injected death instead
        # of losing its own process (in-process GCS chaos tests)
        self._crash_handler = None

    # -- plan management ------------------------------------------------

    def set_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)

    def load_plan(self, plan: dict | None):
        """Install a plan atomically (None or empty rules = heal all)."""
        plan = plan or {}
        rules = plan.get("rules") or []
        with self._lock:
            seed = int(plan.get("seed", self._seed))
            self._seed = seed
            self._endpoints = {
                name: tuple(addrs) if isinstance(addrs, (list, tuple))
                else (addrs,)
                for name, addrs in (plan.get("endpoints") or {}).items()}
            self._rules = tuple(_Rule(spec, i, seed)
                                for i, spec in enumerate(rules))
            if "version" in plan:
                self.version = int(plan["version"])
            self.active = bool(self._rules)

    def clear(self):
        with self._lock:
            self._rules = ()
            self._endpoints = {}
            self.active = False
            self.stats = {}

    # -- consult points -------------------------------------------------

    def check_connect(self, label: str | None, peer):
        """Gate for new outbound connections: raises into an open
        partition (direction ``both``/``send`` — a one-way inbound
        partition still lets this side dial)."""
        if label == FAULT_CONTROL_LABEL:
            return
        peer_key = _peer_key(peer)
        with self._lock:
            for rule in self._rules:
                if rule.fault != PARTITION:
                    continue
                if rule.direction == "recv":
                    continue
                if rule.matches(label, "send", peer_key, None,
                                self._endpoints):
                    self._count(rule)
                    raise InjectedConnectionReset(
                        f"injected partition: {label} -> {peer_key} "
                        f"({rule.rid})")

    def consult(self, label: str | None, direction: str, peer,
                method: str | None) -> str:
        """Decide the fate of one message. Returns PASS / DROP /
        DUPLICATE / RESET (PARTITION maps to RESET: the channel is
        severed and redials are refused by check_connect until healed).
        Delay rules sleep inline and keep scanning."""
        if label == FAULT_CONTROL_LABEL:
            return PASS
        peer_key = _peer_key(peer)
        delay = 0.0
        action = PASS
        with self._lock:
            for rule in self._rules:
                if rule.fault == CRASH:
                    continue   # process fault: fires at maybe_crash only
                if not rule.matches(label, direction, peer_key, method,
                                    self._endpoints):
                    continue
                if not rule.fires():
                    continue
                self._count(rule)
                if rule.fault == DELAY:
                    delay += rule.delay_s
                    continue
                action = RESET if rule.fault == PARTITION else rule.fault
                break
        if delay:
            time.sleep(delay)
        return action

    def maybe_crash(self, point: str):
        """Named crash point. A no-op (one attribute read) unless a plan
        with a matching ``crash`` rule is loaded; on the nth seeded hit
        the process writes a last-words marker to raw fd 2 and dies.
        Registered points (the JAX package's docs/crash_chaos.md) —
        ``gcs.after_wal_append``, ``raylet.before_lease_grant``,
        ``worker.mid_task``, ``replica.mid_decode``, ...
        """
        if not self.active:
            return
        fired = None
        with self._lock:
            for rule in self._rules:
                if rule.fault != CRASH:
                    continue
                if not rule.matches_point(point, self.process_label):
                    continue
                if not rule.fires():
                    continue
                self._count(rule)
                fired = rule
                break
        if fired is None:
            return
        self._die(point, fired)

    def _die(self, point: str, rule: _Rule):
        """Injected death: marker first (raw fd 2 — survives SIGKILL
        because it is already in the .err redirect by the time we die),
        then exit without any cleanup, exactly like a real crash."""
        marker = (f"{CRASH_MARKER} point={point} rule={rule.rid} "
                  f"pid={os.getpid()} "
                  f"proc={self.process_label or '?'}\n")
        try:
            os.write(2, marker.encode())
        except OSError:
            pass
        if self._crash_handler is not None:
            self._crash_handler(point, rule)
            return
        if rule.signal == "kill":
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGKILL)
            time.sleep(60)   # pending-signal window; never returns
        os._exit(137)

    def set_crash_handler(self, fn):
        """Test seam: ``fn(point, rule)`` replaces the injected death
        (None restores real semantics). In-process chaos tests use this
        to crash an embedded server without losing the host process."""
        self._crash_handler = fn

    def _count(self, rule: _Rule):
        self.stats[rule.rid] = self.stats.get(rule.rid, 0) + 1


plane = FaultPlane()


def set_process_label(label: str):
    """Stamp this process's role (``gcs``/``raylet``/``worker``/
    ``driver``) for crash rules' ``proc`` scoping. Entry points call it
    unconditionally — it is one attribute write and must happen even
    when injection is disabled, so a plan enabled later via env in a
    child finds the label in place."""
    plane.process_label = label


def maybe_crash(point: str):
    """Module-level convenience for the process-global plane."""
    plane.maybe_crash(point)


# ----------------------------------------------------------------------
# plan transport (GCS KV)
# ----------------------------------------------------------------------

def decode_plan(value: Any) -> dict | None:
    """KV values may arrive as a dict (python clients) or JSON text."""
    if value is None:
        return None
    if isinstance(value, (bytes, bytearray)):
        value = value.decode()
    if isinstance(value, str):
        value = json.loads(value)
    if not isinstance(value, dict):
        raise ValueError(f"fault plan must be a dict, got {type(value)}")
    return value


def put_plan(gcs_address, plan: dict):
    """Write a plan to the GCS KV switch key over an injection-exempt
    channel (tests open/heal partitions with this while one is open)."""
    from ray_tpu_torch.runtime.rpc import RpcClient

    client = RpcClient(tuple(gcs_address), timeout=10,
                       label=FAULT_CONTROL_LABEL)
    try:
        client.call("kv_put", ns=KV_NS, key=KV_KEY, value=plan, timeout=10)
    finally:
        client.close()


_watcher_lock = threading.Lock()
_watcher_stop: threading.Event | None = None


def start_kv_watcher(gcs_address, poll_s: float = 0.25):
    """Poll the GCS KV plan key and apply version changes to the local
    plane. Idempotent per process; the channel is injection-exempt."""
    global _watcher_stop
    with _watcher_lock:
        if _watcher_stop is not None:
            return
        _watcher_stop = threading.Event()
        stop = _watcher_stop
    address = tuple(gcs_address)

    def _loop():
        from ray_tpu_torch.runtime.rpc import RpcClient

        client = None
        while not stop.wait(poll_s):
            try:
                if client is None:
                    client = RpcClient(address, timeout=5,
                                       label=FAULT_CONTROL_LABEL)
                raw = client.call("kv_get", ns=KV_NS, key=KV_KEY,
                                  timeout=5)
                plan = decode_plan(raw)
                if plan is not None and \
                        int(plan.get("version", 0)) != plane.version:
                    plane.load_plan(plan)
            except Exception:  # noqa: BLE001 - GCS busy/down: redial next
                if client is not None:
                    client.close()
                    client = None
        if client is not None:
            client.close()

    threading.Thread(target=_loop, daemon=True,
                     name="fault-kv-watcher").start()


def stop_kv_watcher():
    global _watcher_stop
    with _watcher_lock:
        if _watcher_stop is not None:
            _watcher_stop.set()
            _watcher_stop = None


def reset_after_fork():
    """Called in a zygote-forked child before any worker code runs: the
    child must start with a FRESH plane (no rules, version -1) and no
    watcher bookkeeping — a template never loads a plan or starts the
    watcher, but the child enforces the invariant rather than assuming
    it. The worker's own ``maybe_init_from_config`` then rebuilds state
    from ITS environment, exactly like a cold-spawned worker."""
    global plane, _watcher_stop
    with _watcher_lock:
        _watcher_stop = None   # watcher threads do not survive fork
    plane = FaultPlane()


def maybe_init_from_config(gcs_address=None, process_label=None):
    """Called by every process entry point (driver runtime, raylet, GCS,
    worker). The role stamp is applied unconditionally; everything else
    is a no-op unless ``RAY_TPU_FAULT_INJECTION_ENABLED`` is set — the
    disabled path costs one config read at startup, nothing per
    message."""
    from ray_tpu_torch.utils.config import get_config

    if process_label is not None:
        set_process_label(process_label)
    cfg = get_config()
    if not cfg.fault_injection_enabled:
        return
    plane.set_seed(cfg.fault_injection_seed)
    raw = cfg.fault_injection_plan
    if raw:
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        plane.load_plan(json.loads(raw))
    if gcs_address is not None:
        start_kv_watcher(tuple(gcs_address), cfg.fault_injection_kv_poll_s)
