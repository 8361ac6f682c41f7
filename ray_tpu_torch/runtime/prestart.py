"""Fork-server worker spawn: preforked zygote templates + prestart policy.

Port of ``ray_tpu/runtime/prestart.py``: the same template protocol,
demand gate, fallback contract and counters (without ``log_stems``, which
only the raylet's log monitor reads: an observability plane, a later
slice). Its fork-safety rule is
CUDA's (below) in place of JAX's XLA-backend rule.

Reference analog: ``src/ray/raylet/worker_pool.h:354`` ``PrestartWorkers``
(the reference keeps a pool of started-but-idle workers sized by lease
demand) combined with the CPython ``forkserver`` / Android zygote
pattern: per (node, runtime-env key) ONE long-lived *template* process
boots, preloads the heavy import set (ray_tpu runtime, serialization,
optionally user ``py_modules``), then answers fork requests over a
framed-RPC control pipe — every subsequent worker is an ``os.fork()``
away instead of a cold interpreter start plus imports.

CUDA fork-safety rule (load-bearing): a child forked from a process in
which the CUDA driver was initialized cannot use the card. The rule is
stricter than "no ``torch.cuda`` call": ``torch.cuda.is_available()`` and
``device_count()`` call ``cuInit`` (unless
``PYTORCH_NVML_BASED_CUDA_CHECK=1``) while ``torch.cuda.is_initialized()``
keeps reading False, and a torch op starts the intra-op thread pool
(fork copies only the calling thread). So the template never resolves a
device, never loads a kernel library (``_kernels.py``) and never runs a
torch op; it does not even import torch, whose import maps the driver's
``libcuda`` on a host with a card. Before every fork it checks both
``torch.cuda.is_initialized()`` and whether a ``libcuda`` is mapped in
``/proc/self/maps`` (:func:`cuda_in_process`), and refuses to serve if
either shows CUDA (the pool then cold-spawns). A forked child sets its
view of the card (``CUDA_VISIBLE_DEVICES`` from the fork request's env)
before its first CUDA call, which it makes as a cold-spawned worker
would.

Fallback contract: every failure in this file degrades to the status
quo. Template not yet warm → cold spawn. Template died (or the chaos
tier injected ``kill_template``) → cold spawn + background respawn of
the template. The worker a fork produces is indistinguishable from a
cold-spawned one: it re-runs the normal ``Worker()`` boot, so it dials
its OWN raylet/GCS channels and carries no fault-injection state from
the template (which never loads any).

Config flags (``ray_tpu_torch/utils/config.py``, env ``RAY_TPU_PRESTART_*``):
``prestart_enabled``, ``prestart_min_workers``,
``prestart_spawn_threshold``, ``prestart_policy_interval_s``,
``prestart_idle_timeout_s``, ``prestart_fork_timeout_s``,
``prestart_max_forks_per_tick``, ``prestart_max_templates``.

Demand gate: a template is only created once an env key accumulates
``prestart_spawn_threshold`` spawn requests (or ``warm()`` is called, or
``prestart_min_workers`` > 0). Below the threshold every request
cold-spawns with zero added cost — a pool that spawns three workers and
exits never pays the template's interpreter start + preload imports,
while an actor fan-out crosses the threshold inside its first wave.
"""

from __future__ import annotations

import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time

from ray_tpu_torch.runtime.rpc import recv_msg, send_msg

# Environment variable carrying the control-pipe fd into the template.
ZYGOTE_FD_ENV = "RAY_TPU_TORCH_ZYGOTE_FD"

# The variables that set a process's view of the card; a fork request
# carries the raylet's current values into the child.
_CARD_VIEW_ENV = ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")

# Set in a forked CHILD by _child_after_fork (test probe: a worker task
# can import this module and verify it was forked, that the template's
# control fd is closed, and which template it came from).
CHILD_INFO: dict | None = None


def libcuda_mapped(pid="self") -> bool:
    """True iff the CUDA driver library (``libcuda.so``, not the runtime
    ``libcudart``) is mapped into process ``pid``."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return False
    return any(os.path.basename(line.split()[-1]).startswith("libcuda.so")
               for line in maps.splitlines() if "libcuda" in line)


def cuda_in_process() -> str | None:
    """Why forking this process is unsafe for CUDA, or None: torch's CUDA
    state initialized, or the driver library mapped (an import of torch
    maps it on a host with a card; a ``cuInit`` needs it)."""
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                return "torch.cuda.is_initialized() is True"
        except Exception:  # noqa: BLE001 - torch internals moved; unsafe
            return "torch.cuda state unreadable"
    if libcuda_mapped():
        return "libcuda is mapped"
    return None


class ForkedProc:
    """Popen-shaped handle for a worker forked BY THE TEMPLATE (so not
    our child: no waitpid — liveness via signal 0, reaping happens in
    the template). Implements the subset of the Popen surface the pool,
    raylet, and memory monitor use."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: int | None = None

    def poll(self):
        if self.returncode is not None:
            return self.returncode
        if _zombie(self.pid):
            # exited, not yet reaped by its parent (the template, or the
            # process that inherited it): dead for every caller here
            self.returncode = -1
            return self.returncode
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            # exit code is unobservable from a non-parent; -1 matches
            # the "killed" convention every caller formats
            self.returncode = -1
            return self.returncode
        except PermissionError:
            return None   # alive under another uid (containers)
        return None

    def wait(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    f"forked-worker-{self.pid}", timeout)
            time.sleep(0.02)
        return self.returncode

    def send_signal(self, sig):
        if self.returncode is not None:
            return
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            self.returncode = -1

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


def _zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            # the state follows the parenthesized command name
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except (OSError, IndexError):
        return False


# ----------------------------------------------------------------------
# raylet side: template handle + manager
# ----------------------------------------------------------------------

class ZygoteTemplate:
    """One template process for one runtime-env key. The control pipe is
    a unix socketpair carrying the same framed messages as every other
    channel (``rpc.send_msg``/``recv_msg``)."""

    def __init__(self, env_key: str, runtime_env: dict | None,
                 base_env: dict, log_dir: str | None):
        self.env_key = env_key
        self.runtime_env = runtime_env
        self.proc: subprocess.Popen | None = None
        self.sock: socket.socket | None = None
        self.ready = False
        self.lock = threading.Lock()   # serializes fork request/reply pairs
        self.last_used = time.monotonic()
        self._base_env = base_env
        self._log_dir = log_dir

    def start(self):
        parent, child = socket.socketpair()
        env = dict(self._base_env)
        env[ZYGOTE_FD_ENV] = str(child.fileno())
        if self.runtime_env:
            env["RAY_TPU_TORCH_RUNTIME_ENV"] = json.dumps(self.runtime_env)
        stdout = stderr = None
        if self._log_dir:
            base = os.path.join(self._log_dir,
                                f"zygote-{(self.env_key or 'default')[:12]}")
            try:
                stdout = open(base + ".out", "ab", buffering=0)
                stderr = open(base + ".err", "ab", buffering=0)
            except OSError:
                if stdout is not None:
                    stdout.close()
                stdout = stderr = None
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.runtime.worker_main",
                 "--zygote"],
                env=env, cwd=os.getcwd(), pass_fds=(child.fileno(),),
                stdout=stdout, stderr=stderr)
        finally:
            if stdout is not None:
                stdout.close()
                stderr.close()
            child.close()
        self.sock = parent
        return self

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def poll_ready(self, timeout: float = 0.0) -> bool:
        """Non-blocking by default: the template announces readiness with
        one framed ``{"ready": True}`` after its preload finishes; until
        then every fork request falls back to cold spawn."""
        if self.ready:
            return True
        if self.sock is None or not self.alive():
            return False
        r, _, _ = select.select([self.sock], [], [], timeout)
        if not r:
            return False
        try:
            self.sock.settimeout(2.0)
            msg = recv_msg(self.sock)
            self.sock.settimeout(None)
        except (OSError, EOFError):
            return False
        self.ready = bool(msg.get("ready"))
        return self.ready

    def fork(self, *, worker_id: str, extra_env: dict,
             log_out: str | None, log_err: str | None,
             timeout: float) -> int:
        """Framed fork RPC; returns the child pid. Raises OSError on any
        transport failure — the caller treats the template as dead (a
        half-done fork request must not be retried on the same pipe:
        request/reply pairing would desync)."""
        with self.lock:
            self.last_used = time.monotonic()
            self.sock.settimeout(timeout)
            try:
                send_msg(self.sock, {"type": "fork",
                                     "worker_id": worker_id,
                                     "env": extra_env,
                                     "log_out": log_out,
                                     "log_err": log_err})
                reply = recv_msg(self.sock)
            finally:
                try:
                    self.sock.settimeout(None)
                except OSError:
                    pass
        if not reply.get("ok"):
            raise OSError(f"template refused fork: {reply.get('error')}")
        return int(reply["pid"])

    def status(self, timeout: float = 5.0) -> dict:
        """Test/observability probe: template pid, preloaded modules,
        and the CUDA fork-safety invariant."""
        with self.lock:
            self.sock.settimeout(timeout)
            try:
                send_msg(self.sock, {"type": "status"})
                return recv_msg(self.sock)
            finally:
                try:
                    self.sock.settimeout(None)
                except OSError:
                    pass

    def close(self, kill: bool = True):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        if self.proc is not None and kill:
            try:
                self.proc.terminate()
            except OSError:
                pass

    def reap(self, timeout: float = 2.0):
        if self.proc is None:
            return
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()


class PrestartManager:
    """Owned by the WorkerPool: env-key → template registry, the fork
    fast path ``fork_worker`` (returns None on ANY miss so the pool cold
    spawns), and counters the node-info endpoint exposes."""

    def __init__(self, pool):
        self._pool = pool
        self.templates: dict[str, ZygoteTemplate] = {}
        self.lock = threading.Lock()
        # env keys whose demand justified a template: explicit warm(),
        # prestart_spawn_threshold cumulative requests, or min_workers>0.
        # Once justified, a key stays justified — a dead template
        # respawns on the next request without re-counting.
        self._justified: set[str] = set()
        self._spawn_requests: dict[str, int] = {}
        self.stats = {"forked": 0, "cold_fallback": 0,
                      "below_threshold": 0,
                      "template_spawns": 0, "template_deaths": 0,
                      "fault_template_kills": 0}

    @property
    def enabled(self) -> bool:
        from ray_tpu_torch.utils.config import get_config
        return get_config().prestart_enabled

    # -- template registry ---------------------------------------------

    def _base_env(self) -> dict:
        """The cold spawn's environment minus the per-worker identity: a
        forked child gets its worker id in the fork request."""
        from ray_tpu_torch.runtime.worker_pool import _worker_pythonpath

        node = self._pool._node
        env = dict(os.environ)
        env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH", ""))
        env.pop("JAX_PLATFORMS", None)
        env.update({
            "RAY_TPU_TORCH_RAYLET_HOST": node.address[0],
            "RAY_TPU_TORCH_RAYLET_PORT": str(node.address[1]),
            "RAY_TPU_TORCH_GCS_HOST": node.gcs_address[0],
            "RAY_TPU_TORCH_GCS_PORT": str(node.gcs_address[1]),
            "RAY_TPU_TORCH_STORE_NAME": node.store_name,
            "RAY_TPU_TORCH_NODE_ID": node.node_id,
            "PYTHONUNBUFFERED": "1",
        })
        env.pop("RAY_TPU_TORCH_WORKER_ID", None)
        env.pop("RAY_TPU_TORCH_RUNTIME_ENV", None)
        return env

    def _get_template(self, key: str, runtime_env: dict | None
                      ) -> ZygoteTemplate | None:
        """Live template for this env key, spawning/respawning as
        needed. Called under ``self.lock``."""
        t = self.templates.get(key)
        if t is not None and not t.alive():
            self.stats["template_deaths"] += 1
            t.close()
            t.reap(timeout=0.5)
            self.templates.pop(key, None)
            t = None
        if t is None:
            from ray_tpu_torch.utils.config import get_config
            cap = max(1, get_config().prestart_max_templates)
            while len(self.templates) >= cap:
                # LRU-evict: mirrors the pool's env-keyed idle eviction —
                # a node cycling through many envs keeps the newest
                victim_key = min(self.templates,
                                 key=lambda k: self.templates[k].last_used)
                victim = self.templates.pop(victim_key)
                victim.close()
                victim.reap(timeout=0.5)
            try:
                node = self._pool._node
                t = ZygoteTemplate(key, runtime_env, self._base_env(),
                                   getattr(node, "log_dir", None)).start()
            except OSError:
                return None
            self.templates[key] = t
            self.stats["template_spawns"] += 1
        return t

    def justified(self, key: str = "") -> bool:
        """True once this env key's demand crossed the spawn threshold
        (or ``warm()`` pinned it). The prestart policy loop keys off
        this: a pool that never showed fork-server demand keeps the
        status-quo scheduler-driven spawning, with zero policy
        side-effects."""
        with self.lock:
            return key in self._justified

    def warm(self, runtime_env: dict | None = None
             ) -> ZygoteTemplate | None:
        """Explicitly spawn the template for this env key, bypassing the
        spawn-request threshold (marks the key demand-justified, so a
        later death respawns too). Returns the template — the caller
        polls ``poll_ready`` — or None when prestart is off / spawn
        failed."""
        if not self.enabled:
            return None
        from ray_tpu_torch.runtime_env import env_key as _env_key

        key = _env_key(runtime_env)
        with self.lock:
            self._justified.add(key)
            return self._get_template(key, runtime_env)

    # -- the fork fast path --------------------------------------------

    def fork_worker(self, runtime_env: dict | None, worker_id: str,
                    log_out: str | None, log_err: str | None):
        """Try to produce a worker by forking the env-keyed template.
        Returns a ForkedProc, or None → the caller cold-spawns."""
        if not self.enabled:
            return None
        if (runtime_env or {}).get("container"):
            return None   # container workers exec inside an image
        from ray_tpu_torch.runtime_env import env_key as _env_key
        from ray_tpu_torch.utils.config import get_config

        key = _env_key(runtime_env)
        cfg = get_config()
        with self.lock:
            if key not in self._justified:
                n = self._spawn_requests.get(key, 0) + 1
                self._spawn_requests[key] = n
                if (n >= max(1, cfg.prestart_spawn_threshold)
                        or cfg.prestart_min_workers > 0):
                    self._justified.add(key)
                else:
                    # not enough cumulative demand to pay for a template
                    # yet: a pool that only ever spawns a handful of
                    # workers (one short-lived test cluster) never eats
                    # the template's interpreter start + preload bill
                    self.stats["below_threshold"] += 1
                    self.stats["cold_fallback"] += 1
                    return None
            t = self._get_template(key, runtime_env)
        if t is None:
            self.stats["cold_fallback"] += 1
            return None
        # chaos hook: a `kill_template` rule (method "fork_worker") in
        # the fault plane kills the template at the worst moment —
        # mid-acquisition — to prove the cold-spawn fallback
        from ray_tpu_torch.runtime import fault_injection as _fi
        if _fi.plane.active:
            action = _fi.plane.consult(
                "raylet", "send", f"zygote:{key or 'default'}",
                "fork_worker")
            if action == _fi.KILL_TEMPLATE and t.proc is not None:
                self.stats["fault_template_kills"] += 1
                try:
                    t.proc.kill()
                    t.proc.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        if not t.poll_ready():
            # template still preloading (or just died): cold spawn now,
            # the template warms up in the background
            self.stats["cold_fallback"] += 1
            return None
        try:
            # the card's view, as a cold spawn would inherit it now
            view = {k: os.environ[k] for k in _CARD_VIEW_ENV
                    if k in os.environ}
            pid = t.fork(worker_id=worker_id, extra_env=view,
                         log_out=log_out, log_err=log_err,
                         timeout=get_config().prestart_fork_timeout_s)
        except (OSError, EOFError, ValueError, KeyError):
            # transport failure mid-fork: the pipe may be desynced and a
            # child may or may not exist — kill the template (an orphan
            # child simply registers as an extra idle worker) and fall
            # back to a cold spawn under a FRESH worker id
            self.stats["cold_fallback"] += 1
            with self.lock:
                if self.templates.get(key) is t:
                    self.stats["template_deaths"] += 1
                    t.close()
                    t.reap(timeout=0.5)
                    self.templates.pop(key, None)
            return None
        self.stats["forked"] += 1
        return ForkedProc(pid)

    # -- observability + shutdown --------------------------------------

    def snapshot(self) -> dict:
        with self.lock:
            return {"templates": {k or "default": {
                        "pid": t.proc.pid if t.proc else None,
                        "ready": t.ready,
                        "alive": t.alive()}
                        for k, t in self.templates.items()},
                    **self.stats}

    def stop(self):
        with self.lock:
            templates = list(self.templates.values())
            self.templates.clear()
        for t in templates:
            t.close()
        for t in templates:
            t.reap()


# ----------------------------------------------------------------------
# template side: the zygote server loop (entered via
# ``python -m ray_tpu_torch.runtime.worker_main --zygote``)
# ----------------------------------------------------------------------

_PRELOAD_MODULES = (
    # the worker boot's import closure — this is the cold-start cost a
    # fork skips. Not torch: its import maps libcuda (see the module
    # docstring), so a forked child imports torch itself.
    "ray_tpu_torch._private.shm_store",
    "ray_tpu_torch.runtime.object_codec",
    "ray_tpu_torch.runtime.rpc",
    "ray_tpu_torch.runtime.refcount",
    "ray_tpu_torch.runtime.fault_injection",
    "ray_tpu_torch.runtime_env",
    "ray_tpu_torch.runtime.worker_main",
    "ray_tpu_torch.utils.exceptions",
    "ray_tpu_torch.utils.config",
    "numpy",
)


def _preload() -> list[str]:
    import importlib

    loaded = []
    for name in _PRELOAD_MODULES:
        try:
            importlib.import_module(name)
            loaded.append(name)
        except Exception:  # noqa: BLE001 - optional module absent
            pass
    # user env prewarm: pip install / working_dir snapshot / py_modules
    # copies happen ONCE here (apply_paths is the additive, chdir-free
    # half of apply_runtime_env) so the per-child apply in Worker() hits
    # warm caches. User modules are NOT imported eagerly — import side
    # effects could initialize CUDA and break the fork-safety rule.
    renv_raw = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if renv_raw:
        try:
            from ray_tpu_torch.runtime_env import apply_paths
            apply_paths(json.loads(renv_raw))
        except Exception:  # noqa: BLE001 - child applies + reports errors
            pass
    return loaded


def _child_after_fork(ctrl: socket.socket, req: dict):
    """Runs in the forked CHILD, before any worker code: sever every
    inherited handle so the worker is indistinguishable from a cold
    spawn. Only then boot ``Worker()`` (which dials its own channels)."""
    global CHILD_INFO
    ctrl_fd = ctrl.fileno()
    template_pid = os.getppid()
    ctrl.close()   # the template's control pipe MUST not leak into workers
    # per-worker log capture (the cold path redirects via Popen; here
    # the child re-points its own stdio post-fork)
    for path, fd in ((req.get("log_out"), 1), (req.get("log_err"), 2)):
        if path:
            try:
                f = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                            0o644)
                os.dup2(f, fd)
                os.close(f)
            except OSError:
                pass
    os.environ["RAY_TPU_TORCH_WORKER_ID"] = req["worker_id"]
    # the request's env (the card's view, CUDA_VISIBLE_DEVICES, among it)
    # lands before the worker boots: its first CUDA call reads it
    for k, v in (req.get("env") or {}).items():
        os.environ[k] = str(v)
    os.environ.pop(ZYGOTE_FD_ENV, None)
    # fresh per-process state: config rereads env, the fault plane
    # starts empty (the template never loads one, but the invariant is
    # enforced here, not assumed), RNG reseeds
    from ray_tpu_torch.runtime import fault_injection as _fi
    _fi.reset_after_fork()
    from ray_tpu_torch.utils.config import reset_config
    reset_config()
    import random
    random.seed(os.urandom(16))
    CHILD_INFO = {"template_pid": template_pid, "ctrl_fd": ctrl_fd}
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    from ray_tpu_torch.runtime.worker_main import Worker
    Worker().run()


def zygote_main() -> int:
    """Template process main: preload, announce readiness, serve fork
    requests. SINGLE-THREADED by design — ``os.fork()`` from a process
    with live threads inherits locked locks; the reap of exited children
    happens inline between control-pipe polls instead of on a thread."""
    fd = int(os.environ[ZYGOTE_FD_ENV])
    ctrl = socket.socket(fileno=fd)
    # SIGTERM = raylet shutdown: exit without touching children (live
    # workers outlive their template; the raylet owns THEIR lifecycle)
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    loaded = _preload()
    unsafe = cuda_in_process()
    if unsafe:
        # the preload (or a module the interpreter imported at start)
        # broke the fork-safety rule: refuse service (the manager
        # cold-spawns everything) rather than fork CUDA state into
        # children that could not use the card
        try:
            send_msg(ctrl, {"ready": False,
                            "error": f"CUDA in template: {unsafe}"})
        except OSError:
            pass
        return 1
    try:
        send_msg(ctrl, {"ready": True, "pid": os.getpid()})
    except OSError:
        return 1
    while True:
        # reap exited children (non-blocking: they are OUR children even
        # though the raylet manages their lifecycle)
        try:
            while os.waitpid(-1, os.WNOHANG)[0] != 0:
                pass
        except ChildProcessError:
            pass
        r, _, _ = select.select([ctrl], [], [], 0.5)
        if not r:
            continue
        try:
            req = recv_msg(ctrl)
        except (OSError, EOFError):
            return 0   # raylet closed the pipe: shut down
        kind = req.get("type")
        if kind == "fork":
            unsafe = cuda_in_process()
            if unsafe:
                send_msg(ctrl, {"ok": False,
                                "error": f"CUDA in template: {unsafe}"})
                continue
            pid = os.fork()
            if pid == 0:
                try:
                    _child_after_fork(ctrl, req)
                finally:
                    os._exit(0)
            try:
                send_msg(ctrl, {"ok": True, "pid": pid})
            except OSError:
                return 0
        elif kind == "status":
            send_msg(ctrl, {
                "ok": True, "pid": os.getpid(), "preloaded": loaded,
                "torch_imported": "torch" in sys.modules,
                "cuda_initialized": cuda_in_process() is not None,
                "libcuda_mapped": libcuda_mapped(),
                "threads": threading.active_count()})
        elif kind == "exit":
            return 0
