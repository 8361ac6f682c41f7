"""Per-node worker pool: spawn, registration handshake, idle caching,
death handling, and the memory-pressure kill policy.

Port of ``ray_tpu/runtime/worker_pool.py`` with its prestart fork server
(``runtime/prestart.py``): a worker is an ``os.fork()`` of the env-keyed
zygote template once that key's demand justified one, else a fresh
``python -m ray_tpu_torch.runtime.worker_main`` (also on every template
miss). The prestart policy loop keeps forked workers warm against the
lease queue's depth, and an idle warm worker takes over an actor creation.
A worker boots with its runtime env (``RAY_TPU_TORCH_RUNTIME_ENV``;
container envs run the worker inside the image). Workers inherit the
environment's view of the card, as JAX's inherit ``JAX_PLATFORMS``; a
worker that touches no tensor on the card makes no CUDA context, and a
template never makes one (its fork-safety check refuses to serve if it
finds CUDA initialized).

Reference analog: ``src/ray/raylet/worker_pool.cc`` (spawn + registration
handshake + env-keyed idle caching + eviction beyond the soft limit) and
``worker_killing_policy_retriable_fifo.cc`` (the OOM victim policy). The
pool is a component OWNED by the raylet (``runtime/raylet.py``): the
raylet keeps scheduling/leases/actors and delegates worker lifecycle
here; task-retry decisions on worker death call back into the raylet's
queueing/error paths so the policy stays in one place.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.runtime.rpc import RpcServer, recv_msg, send_msg
from ray_tpu_torch.utils.ids import WorkerID


@dataclass
class WorkerHandle:
    worker_id: str
    proc: subprocess.Popen | None = None
    conn: Any = None            # held task-channel socket
    send_lock: Any = None
    state: str = "starting"     # starting | idle | busy | leased | actor | dead
    # owner-facing task port (worker-lease protocol); leases hand this
    # address to the owner, which pushes tasks to it directly
    push_addr: tuple | None = None
    actor_id: str | None = None
    incarnation: int = 0
    current_task: dict | None = None
    acquired: dict = field(default_factory=dict)
    # set by the memory monitor right before a pressure kill so the death
    # handler stores OutOfMemoryError instead of WorkerCrashedError
    oom_killed: bool = False
    # captured stdout/stderr file paths (tailed by the raylet log
    # monitor and forwarded to drivers)
    log_out: str | None = None
    log_err: str | None = None
    dispatched_at: float = 0.0   # monotonic time the current task started
    # runtime-env identity this worker booted with; tasks only run on a
    # worker with a matching key (reference: (language, runtime_env)-
    # keyed worker caching in worker_pool.cc)
    env_key: str = ""
    # monotonic time of the last busy→idle transition; the prestart
    # policy evicts idle workers beyond the demand target older than
    # prestart_idle_timeout_s
    idle_since: float = 0.0
    # spawned via the zygote fork path (runtime/prestart.py)
    forked: bool = False


class WorkerPool:
    """Worker lifecycle for one raylet. ``node`` is the owning Raylet —
    the pool reads its identity/addresses and calls back into its
    scheduling (enqueue/release/kick) and error (store_task_error)
    paths."""

    BAD_ENV_TTL_S = 60.0

    def __init__(self, node, *, max_workers: int):
        from ray_tpu_torch.runtime.prestart import PrestartManager

        self._node = node
        self.max_workers = max_workers
        self.workers: dict[str, WorkerHandle] = {}
        self.lock = threading.Lock()
        # fork-server templates (runtime/prestart.py): lazy — no process
        # is spawned until the first fork attempt
        self.prestart = PrestartManager(self)
        # actor-creation misses since the last policy tick: actors do
        # not flow through the lease queue, so take_idle_for_actor
        # misses are their demand signal to the prestart policy
        self._actor_demand = 0
        # why recent workers died, queried by lease owners on break
        # (bounded FIFO; reference: worker exit detail in death reports)
        self._death_info: dict[str, dict] = {}
        # env_key -> (error, when): envs whose setup failed — tasks fail
        # fast instead of driving a spawn/install/crash loop
        self._bad_envs: dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # spawn + registration (reference: worker_pool.cc StartWorkerProcess
    # + RegisterWorker handshake)
    # ------------------------------------------------------------------

    def spawn(self, runtime_env: dict | None = None) -> WorkerHandle:
        from ray_tpu_torch.runtime_env import env_key as _env_key

        node = self._node
        worker_id = WorkerID.from_random().hex()
        env = dict(os.environ)
        env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
        env.pop("JAX_PLATFORMS", None)
        env.pop("RAY_TPU_TORCH_RUNTIME_ENV", None)
        if runtime_env:
            env["RAY_TPU_TORCH_RUNTIME_ENV"] = json.dumps(runtime_env)
        env.update({
            "RAY_TPU_TORCH_RAYLET_HOST": node.address[0],
            "RAY_TPU_TORCH_RAYLET_PORT": str(node.address[1]),
            "RAY_TPU_TORCH_GCS_HOST": node.gcs_address[0],
            "RAY_TPU_TORCH_GCS_PORT": str(node.gcs_address[1]),
            "RAY_TPU_TORCH_STORE_NAME": node.store_name,
            "RAY_TPU_TORCH_WORKER_ID": worker_id,
            "RAY_TPU_TORCH_NODE_ID": node.node_id,
            # stdout is a file: unbuffered, a crash's last words are on
            # disk before the process dies
            "PYTHONUNBUFFERED": "1",
        })
        # the worker's stdout/stderr go to files in the raylet's log dir:
        # a dead worker's last words feed its death info
        log_dir = getattr(node, "log_dir", None)
        log_out = log_err = None
        if log_dir:
            base = os.path.join(log_dir, f"worker-{worker_id[:12]}")
            log_out, log_err = base + ".out", base + ".err"
        # fork fast path: an os.fork() of the preloaded env-keyed
        # template instead of a cold interpreter start; any miss
        # (disabled, template warming/dead, container env) returns None
        # and the cold path below runs unchanged
        fork_proc = self.prestart.fork_worker(runtime_env, worker_id,
                                              log_out, log_err)
        if fork_proc is not None:
            handle = WorkerHandle(worker_id=worker_id, proc=fork_proc,
                                  env_key=_env_key(runtime_env),
                                  forked=True)
            handle.log_out, handle.log_err = log_out, log_err
            with self.lock:
                self.workers[worker_id] = handle
            return handle
        cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.worker_main"]
        container = (runtime_env or {}).get("container")
        if container:
            # CONTAINER worker (reference: runtime_env/container.py —
            # the worker process itself runs in the image). Host
            # networking + host IPC keep the raylet channel and the
            # /dev/shm object store working unchanged.
            from ray_tpu_torch.runtime_env import (container_command,
                                                   find_container_runtime)

            runtime = find_container_runtime()
            if runtime is None:
                # fail every queued task for this env fast instead of a
                # spawn/crash loop (same path a worker-side env setup
                # failure takes); the spawned stand-in exits immediately
                # and the monitor reaps it like any dead worker
                node.rpc_runtime_env_failed(
                    None, None, key=_env_key(runtime_env),
                    error="runtime_env.container requested but no "
                          "docker/podman on PATH")
                cmd = [sys.executable, "-c", "raise SystemExit(1)"]
            else:
                cmd = container_command(
                    container,
                    ["python", "-m", "ray_tpu_torch.runtime.worker_main"],
                    env, runtime=runtime)
        stdout = stderr = None
        if log_out:
            try:
                stdout = open(log_out, "ab", buffering=0)
                stderr = open(log_err, "ab", buffering=0)
            except OSError:
                # disk-full/permission: run uncaptured, don't leak the
                # half-opened fd
                if stdout is not None:
                    stdout.close()
                stdout = stderr = None
                log_out = log_err = None
        try:
            proc = subprocess.Popen(cmd, env=env, cwd=os.getcwd(),
                                    stdout=stdout, stderr=stderr)
        finally:
            # Popen dup'd the fds; our handles can close immediately
            if stdout is not None:
                stdout.close()
                stderr.close()
        handle = WorkerHandle(worker_id=worker_id, proc=proc,
                              env_key=_env_key(runtime_env))
        handle.log_out, handle.log_err = log_out, log_err
        with self.lock:
            self.workers[worker_id] = handle
        return handle

    def register(self, conn, send_lock, *, worker_id, push_addr=None):
        """Registration handshake; the connection becomes the raylet→worker
        task channel and worker→raylet completion stream. Runs the
        channel's read loop and returns ``RpcServer.HELD``."""
        node = self._node
        with self.lock:
            handle = self.workers.get(worker_id)
            if handle is None:   # externally started worker (tests)
                handle = WorkerHandle(worker_id=worker_id)
                self.workers[worker_id] = handle
            if push_addr is not None:
                handle.push_addr = tuple(push_addr)
        # the registration ack MUST be the channel's first message: only
        # AFTER it is on the wire may other threads see handle.conn —
        # an actor-delivery thread polling for the conn could otherwise
        # inject create_actor ahead of the ack and fail the handshake
        send_msg(conn, {"registered": True}, send_lock)
        with self.lock:
            handle.conn = conn
            handle.send_lock = send_lock
            if handle.state == "starting":
                # actor-designated workers keep their "actor" state — the
                # dispatcher must never hand them normal tasks
                handle.state = "idle"
                handle.idle_since = time.monotonic()
        node._kick_dispatch()
        try:
            while not node._stopping:
                try:
                    msg = recv_msg(conn)
                except (OSError, EOFError, Exception):
                    break
                self._on_worker_msg(handle, msg)
        finally:
            node.release_conn(conn)   # held channel finished
            self.on_worker_gone(handle)
        return RpcServer.HELD

    def _on_worker_msg(self, w: WorkerHandle, msg: dict):
        node = self._node
        kind = msg.get("type")
        if kind == "task_done":
            self._finish_task(w)
        elif kind == "actor_ready":
            # batched ack: the node's flusher coalesces a creation
            # flood's readies into one actors_ready frame per linger
            node.queue_actor_ready(
                msg["actor_id"],
                list(w.push_addr) if w.push_addr else None)
        elif kind == "actor_creation_failed":
            with node._gcs_lock:
                node._gcs.call("actor_failed", actor_id=msg["actor_id"],
                               reason=msg.get("reason", "creation failed"))

    def _finish_task(self, w: WorkerHandle):
        node = self._node
        with self.lock:
            w.current_task = None
        if w.state == "busy":
            # actor workers keep their acquisition for their LIFETIME
            # (released on death/kill); only per-task resources return here
            node._release(w.acquired)
            w.acquired = {}
            w.idle_since = time.monotonic()
            w.state = "idle"
        node._kick_dispatch()

    # ------------------------------------------------------------------
    # death handling (reference: NodeManager worker failure path)
    # ------------------------------------------------------------------

    def on_worker_gone(self, w: WorkerHandle):
        """Worker process/channel died: record death info, reclaim store
        refs, and hand the in-flight task to the raylet's retry/error
        policy."""
        node = self._node
        if node._stopping:
            return
        info = {"oom_killed": w.oom_killed}
        if w.proc is not None:
            info["exit_code"] = w.proc.poll()
        # the raw .err redirect holds the interpreter-level last words
        # (and the fault plane's injected-crash marker): harvest them
        # into death info so the lease/actor layers can surface a typed,
        # attributed error
        info.update(_last_words(w.log_err))
        with self.lock:
            if w.state == "dead":
                return  # channel reader and monitor both report deaths
            prior_state = w.state
            w.state = "dead"
            self.workers.pop(w.worker_id, None)
            self._death_info[w.worker_id] = info
            while len(self._death_info) > 256:
                self._death_info.pop(next(iter(self._death_info)))
        # reclaim created-but-unsealed allocations and pinned read refs of
        # the dead worker only (live writers/readers are untouched)
        if w.proc is not None and w.proc.pid:
            node.store.evict_orphans(w.proc.pid)
            node.store.release_pid(w.proc.pid)
        task = w.current_task
        node._release(w.acquired)
        w.acquired = {}
        if prior_state == "actor" and w.actor_id is not None:
            reason = f"actor worker {w.worker_id[:8]} died"
            if info.get("crash_point"):
                reason += f" at crash point {info['crash_point']}"
            try:
                with node._gcs_lock:
                    node._gcs.call(
                        "actor_failed", actor_id=w.actor_id,
                        reason=reason)
            except Exception:  # noqa: BLE001 - gcs may be shutting down
                pass
        elif task is not None:
            node._retry_or_fail_dead_worker_task(w, task)
        # proactive respawn: a crashed worker whose slot had parked lease
        # waiters (or a leased channel an owner will re-acquire) should
        # not wait for the next demand-driven spawn — kick the dispatch
        # loop so _serve_lease_waiters spawns/grants a replacement now
        node._kick_dispatch()

    def death_info(self, worker_id: str) -> dict | None:
        with self.lock:
            return self._death_info.get(worker_id)

    # ------------------------------------------------------------------
    # failed runtime envs (fail fast instead of spawn/install/crash loops)
    # ------------------------------------------------------------------

    def mark_bad_env(self, key: str, error: str):
        self._bad_envs[key] = (error, time.monotonic())

    def bad_env_error(self, runtime_env) -> str | None:
        from ray_tpu_torch.runtime_env import env_key as _env_key

        hit = self._bad_envs.get(_env_key(runtime_env))
        if hit is None:
            return None
        error, at = hit
        if time.monotonic() - at > self.BAD_ENV_TTL_S:
            return None   # stale: the env may be fixable (cache purged)
        return error

    # ------------------------------------------------------------------
    # idle caching + eviction (reference: worker_pool.cc PopWorker +
    # idle eviction beyond the cached-soft-limit)
    # ------------------------------------------------------------------

    def idle_worker(self, runtime_env: dict | None = None
                    ) -> WorkerHandle | None:
        """Grab an idle registered worker WITH a matching runtime-env
        key; spawn one for this env when under the cap. At the cap, an
        idle worker with a DIFFERENT env key is evicted to make room —
        otherwise a full pool of mismatched-env workers starves the task
        forever (reference: worker_pool.cc kills idle workers beyond the
        cached-soft-limit when a lease needs a different runtime_env)."""
        from ray_tpu_torch.runtime_env import env_key as _env_key

        key = _env_key(runtime_env)
        evict = None
        with self.lock:
            n_alive = 0
            incoming = False  # replacement with this env already booting?
            for w in self.workers.values():
                # DEDICATED actor workers are not pool capacity: they
                # hold their own acquired resources for their lifetime.
                # Counting them against max_workers starves every task
                # on an actor-heavy node (500 idle actors on a 4-cpu
                # node left ZERO task workers spawnable at the envelope
                # tier — reference: worker_pool.cc caps the POOL, not
                # dedicated workers).
                if w.state in ("idle", "busy", "starting", "leased"):
                    n_alive += 1
                if w.state == "starting" and w.env_key == key:
                    incoming = True
                if (w.state == "idle" and w.conn is not None
                        and w.env_key == key):
                    w.state = "busy"
                    return w
            if incoming:
                # a matching worker is already on its way — evicting more
                # warm workers per dispatch retry would drain the whole
                # pool for one task
                return None
            spawn = n_alive < self.max_workers
            if not spawn:
                for w in self.workers.values():
                    if (w.state == "idle" and w.conn is not None
                            and w.env_key != key):
                        # not "dead": on_worker_gone must still run its
                        # cleanup (pop from registry, store refs, zombie
                        # reap) when the channel closes
                        w.state = "evicting"
                        evict = w
                        spawn = True
                        break
        if evict is not None:
            self._evict_async(evict)
        if spawn:
            self.spawn(runtime_env)
        return None

    def _evict_async(self, w: WorkerHandle):
        """Terminate an idle worker off the calling thread: a worker
        slow to honor SIGTERM must not stall dispatch (or the prestart
        policy tick) for every other queued task."""
        def _reap():
            try:
                if w.proc is not None:
                    w.proc.terminate()
                if w.conn is not None:
                    w.conn.close()
            except OSError:
                pass
            self.on_worker_gone(w)
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    w.proc.kill()

        threading.Thread(target=_reap, name="ray_tpu-evict",
                         daemon=True).start()

    def take_idle_for_actor(self, runtime_env: dict | None = None
                            ) -> WorkerHandle | None:
        """Dedicate an already-registered idle worker (matching env key)
        to an actor instead of spawning a fresh process — with the fork
        pool keeping idle workers warm this makes actor creation an RPC
        away (reference: PopWorker serving actor-creation leases from
        the started-worker pool). Gated on prestart_enabled so the
        legacy fresh-process-per-actor behavior is preserved when the
        subsystem is off."""
        if not self.prestart.enabled:
            return None
        from ray_tpu_torch.runtime_env import env_key as _env_key

        key = _env_key(runtime_env)
        with self.lock:
            for w in self.workers.values():
                if (w.state == "idle" and w.conn is not None
                        and w.env_key == key):
                    w.state = "actor"
                    return w
            self._actor_demand += 1
        return None

    # ------------------------------------------------------------------
    # prestart policy (reference: worker_pool.h:354 PrestartWorkers —
    # lease-demand-driven warm pool + idle eviction beyond the target)
    # ------------------------------------------------------------------

    def prestart_policy_loop(self):
        from ray_tpu_torch.utils.config import get_config

        node = self._node
        cfg = get_config()
        if not cfg.prestart_enabled:
            return
        while not node._stopping:
            node._interruptible_sleep(cfg.prestart_policy_interval_s)
            if node._stopping:
                return
            try:
                self._prestart_tick(cfg)
            except Exception:  # noqa: BLE001 - policy must never die
                pass

    def _prestart_tick(self, cfg):
        """One policy decision: predict demand from lease-queue + ready-
        queue depth, fork up to the deficit, evict idle workers beyond
        the target that outlived the idle timeout."""
        # The policy only acts where fork-server demand exists: the
        # default env key crossed the spawn threshold, or an explicit
        # warm floor is configured. Ungated, every transient queue blip
        # in a small short-lived pool would speculatively spawn workers
        # the scheduler's own demand spawning already covers.
        if (cfg.prestart_min_workers <= 0
                and not self.prestart.justified("")):
            return
        sched = self._node.scheduler
        with sched.cv:
            depth = len(sched.ready) + len(sched.lease_waiters)
        now = time.monotonic()
        with self.lock:
            # an actor-creation burst shows up as take_idle misses, not
            # queue depth — fold it in so the next wave of creations is
            # served by warm takeovers instead of per-actor forks
            depth += self._actor_demand
            self._actor_demand = 0
            idle = [w for w in self.workers.values()
                    if w.state == "idle" and w.conn is not None
                    and w.env_key == ""]
            n_starting = sum(1 for w in self.workers.values()
                             if w.state == "starting")
            n_alive = sum(1 for w in self.workers.values()
                          if w.state in ("idle", "busy", "starting",
                                         "leased"))
        want = min(max(depth, cfg.prestart_min_workers), self.max_workers)
        deficit = min(want - (len(idle) + n_starting),
                      self.max_workers - n_alive,
                      cfg.prestart_max_forks_per_tick)
        for _ in range(max(0, deficit)):
            self.spawn(None)
        if cfg.prestart_idle_timeout_s <= 0:
            return
        floor = max(want, cfg.prestart_min_workers)
        excess = len(idle) - floor
        if excess <= 0:
            return
        victims = []
        with self.lock:
            for w in sorted(idle, key=lambda w: w.idle_since):
                if len(victims) >= excess:
                    break
                if (w.state == "idle"
                        and now - w.idle_since
                        > cfg.prestart_idle_timeout_s):
                    w.state = "evicting"
                    victims.append(w)
        for w in victims:
            self._evict_async(w)

    # ------------------------------------------------------------------
    # background loops (driven by the raylet's thread registry)
    # ------------------------------------------------------------------

    def monitor_loop(self):
        """Reap dead worker processes (reference: worker failure detection
        via socket + SIGCHLD in NodeManager)."""
        node = self._node
        while not node._stopping:
            time.sleep(0.1)
            with self.lock:
                dead = [w for w in self.workers.values()
                        if w.proc is not None and w.proc.poll() is not None
                        and w.state != "dead"]
            for w in dead:
                self.on_worker_gone(w)

    # --- memory monitor (reference: MemoryMonitor memory_monitor.h:52
    # driving the raylet's WorkerKillingPolicy — kill the newest retriable
    # task's worker first so forward progress is preserved) ---

    @staticmethod
    def host_memory_fraction() -> float:
        """Used fraction of host memory from /proc/meminfo (the reference
        also honors cgroup limits)."""
        total = avail = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1])
                    if total is not None and avail is not None:
                        break
        except OSError:
            return 0.0
        if not total or avail is None:
            return 0.0
        return 1.0 - avail / total

    def memory_monitor_loop(self, threshold: float, refresh_s: float):
        node = self._node
        while not node._stopping:
            node._interruptible_sleep(refresh_s)
            if node._stopping:
                return
            if self.host_memory_fraction() < threshold:
                continue
            if self.kill_one_for_memory():
                node._interruptible_sleep(1.0)  # let the kill take effect

    def kill_one_for_memory(self) -> bool:
        """Pick and kill one worker to relieve pressure. Policy (reference
        worker_killing_policy_retriable_fifo.cc): newest-started RETRIABLE
        task first (its re-execution is cheapest and guaranteed safe),
        then newest non-retriable task worker; actors are never chosen —
        their state is not re-executable (the reference's group-by-owner
        policy similarly deprioritizes them)."""
        with self.lock:
            # select AND kill inside the lock: a victim finishing its task
            # in between would take the SIGKILL for a brand-new task
            busy = [(w, w.current_task, w.dispatched_at)
                    for w in self.workers.values()
                    if w.state == "busy" and w.current_task is not None
                    and w.proc is not None]
            # leased workers are candidates too: their owner observes the
            # break, queries worker_death_info, and applies ITS OOM retry
            # budget (this raylet does not know the task)
            leased = [(w, None, w.dispatched_at)
                      for w in self.workers.values()
                      if w.state == "leased" and w.proc is not None]
            if not busy and not leased:
                return False
            busy.sort(key=lambda it: it[2])   # oldest-dispatched first
            leased.sort(key=lambda it: it[2])
            retriable = [it for it in busy
                         if it[1].get("max_retries", 0) > 0]
            # newest-dispatched first among: retriable (cheapest safe
            # re-run), then leased (owner-managed retry), then the rest
            victim = (retriable or leased or busy)[-1][0]
            victim.oom_killed = True
            try:
                victim.proc.kill()
            except OSError:
                victim.oom_killed = False  # a later crash is NOT an OOM
                return False
        return True

    # ------------------------------------------------------------------

    def stop(self):
        """Terminate every worker process (called from Raylet.stop after
        background loops have been joined)."""
        self.prestart.stop()
        with self.lock:
            workers = list(self.workers.values())
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    w.proc.kill()


def _worker_pythonpath(current: str) -> str:
    """PYTHONPATH for spawned workers: the port's package root, then the
    spawning process's ``sys.path`` directories (as multiprocessing's
    spawn start method hands a child its parent's path, so a module-level
    function of a module the driver imported by path reaches its
    workers), then the inherited entries, minus directories that install
    a ``sitecustomize`` hook: such hooks eagerly import heavyweight
    runtimes and add seconds to EVERY worker spawn. Set
    RAY_TPU_WORKER_KEEP_SITE=1 to keep them."""
    import ray_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))
    entries = [pkg_root]
    keep_site = os.environ.get("RAY_TPU_WORKER_KEEP_SITE") == "1"
    inherited = current.split(os.pathsep)
    stdlib = (sys.prefix, sys.base_prefix, sys.exec_prefix)
    for p in [*sys.path, *inherited]:
        p = os.path.abspath(p) if p else ""
        if not p or p in entries or not os.path.isdir(p):
            continue
        if p.startswith(stdlib) and p not in inherited:
            continue   # the interpreter's own paths: it finds them itself
        if not keep_site and os.path.exists(
                os.path.join(p, "sitecustomize.py")):
            continue
        entries.append(p)
    return os.pathsep.join(entries)


def _last_words(path: str | None, nbytes: int = 4096) -> dict:
    """Tail a dead worker's raw ``.err`` redirect: the last non-empty
    lines plus the injected crash-point name when the fault plane killed
    it (SIGKILL leaves nothing else; the redirect is all there is)."""
    if not path:
        return {}
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - nbytes))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return {}
    lines = [ln.strip() for ln in tail.splitlines() if ln.strip()]
    if not lines:
        return {}
    out: dict = {"last_words": lines[-6:]}
    from ray_tpu_torch.runtime import fault_injection as _fi

    for ln in reversed(lines):
        if _fi.CRASH_MARKER in ln:
            for part in ln.split():
                if part.startswith("point="):
                    out["crash_point"] = part[6:]
            break
    return out
