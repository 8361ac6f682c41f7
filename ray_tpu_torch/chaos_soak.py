"""Chaos soak harness: seeded crash/partition schedule over a mixed
workload, with conservation invariants.

Port of ``ray_tpu/chaos_soak.py`` over the port's supervisor, GCS
restarts and fault plane, with the same schedule, workloads, ledgers and
MTTR accounting. The workloads' task, actor and deployment bodies are
module-level (the port carries them by stdlib pickle). The invariants
that read the metrics and log planes are JAX's: both planes still answer
at the end, and an injected crash's last words reach the log plane as a
``crash`` group of ``summarize_errors()`` (the raylets' harvested death
info is reported beside it). The ``partition`` class cuts the metrics
push channel (the pushers' and the log monitors' connections carry the
``metrics`` label). The invariants that read the tracing plane (no stuck
calls, the trace plane answers) wait for it.
JAX's multi-seed driver (``run_soak_matrix``, with its health-probe
overhead guard) has no caller in the port and is left out.

The tentpole acceptance driver for the crash chaos plane
(``runtime/fault_injection.py`` crash rules + the recovery paths:
raylet worker respawn, cluster raylet/GCS supervision, serve replica
failover). One soak run:

1. builds a supervised multi-node cluster (external fault-tolerant GCS,
   external raylets) and a serve deployment,
2. drives three concurrent workloads — plain tasks, an actor, serve
   calls + streams — for ``duration_s``,
3. replays a SEEDED schedule of fault injections: crash plans switched
   through the GCS KV plan key (worker / replica / raylet / GCS crash
   points) plus metrics-plane partitions,
4. asserts conservation at the end: every submitted op's ``get()``
   resolved or raised a TYPED ``RayTpuError`` (never a bare redial
   ``TimeoutError``), nothing wedged in ``stuck_calls()``, no fd or
   thread leaks in the driver, and the observability planes still
   answer,
5. records per-fault-class MTTR (see the JAX package's
   ``docs/crash_chaos.md`` for the per-class definitions) into a
   ``CHAOS_*.json`` style document.

Same seed + same classes ⇒ same injection schedule: the schedule RNG is
``random.Random(seed)`` and every crash rule carries the plan seed, so a
failure reproduces by re-running with the seed printed in the report.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time


FAULT_CLASSES = ("worker", "replica", "raylet", "gcs")

# crash-plan templates per fault class: what the KV switch installs for
# one injection window (nth=1, max_hits=1 ⇒ at most one death per
# process that reaches the point while the window is open)
_CLASS_RULES = {
    "worker": [
        {"id": "soak-worker-task", "fault": "crash",
         "point": "worker.mid_task", "proc": "worker",
         "nth": 1, "max_hits": 1},
        {"id": "soak-actor", "fault": "crash",
         "point": "soak.actor_bump", "proc": "worker",
         "nth": 1, "max_hits": 1},
    ],
    "replica": [
        {"id": "soak-replica", "fault": "crash",
         "point": "replica.mid_*", "proc": "worker",
         "nth": 1, "max_hits": 1},
    ],
    "raylet": [
        {"id": "soak-raylet", "fault": "crash",
         "point": "raylet.before_lease_grant", "proc": "raylet",
         "nth": 1, "max_hits": 1},
    ],
    "gcs": [
        {"id": "soak-gcs", "fault": "crash",
         "point": "gcs.after_wal_append", "proc": "gcs",
         "nth": 1, "max_hits": 1},
    ],
}


def _soak_task(x):
    return x * 2


class _SoakCounter:
    def __init__(self):
        self.n = 0

    def bump(self):
        from ray_tpu_torch.runtime import fault_injection as _fi
        _fi.maybe_crash("soak.actor_bump")
        self.n += 1
        return self.n


class _SoakEcho:
    def __call__(self, x):
        return {"echo": x}

    def chunks(self, n):
        for i in range(n):
            yield i


class _Workload:
    """One workload loop's ledger: every submitted op ends up as exactly
    one record, so conservation is checkable by scanning the ledger."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.ops: list[dict] = []

    def record(self, submitted: float, done: float, ok: bool,
               error: BaseException | None = None):
        from ray_tpu_torch.utils.exceptions import RayTpuError
        rec = {"submitted": submitted, "done": done, "ok": ok}
        if error is not None:
            rec["error"] = type(error).__name__
            rec["typed"] = isinstance(error, RayTpuError)
            rec["detail"] = repr(error)[:200]
        with self.lock:
            self.ops.append(rec)

    def summary(self) -> dict:
        with self.lock:
            ops = list(self.ops)
        out = {"submitted": len(ops),
               "ok": sum(1 for o in ops if o["ok"]),
               "typed_errors": sum(1 for o in ops
                                   if not o["ok"] and o.get("typed")),
               "untyped_errors": sum(1 for o in ops
                                     if not o["ok"] and not o.get("typed"))}
        return out

    def untyped(self) -> list[dict]:
        with self.lock:
            return [o for o in self.ops
                    if not o["ok"] and not o.get("typed")]

    def first_ok_after(self, t: float) -> float | None:
        """done-timestamp of the earliest successful op SUBMITTED after
        t — the workload-visible recovery point for a fault at t."""
        with self.lock:
            cands = [o["done"] for o in self.ops
                     if o["ok"] and o["submitted"] > t]
        return min(cands) if cands else None


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def run_soak(duration_s: float = 300.0, seed: int = 0,
             classes=FAULT_CLASSES, *, inject_period_s: float = 8.0,
             partitions: bool = True, serve_replicas: int = 2,
             get_timeout_s: float = 30.0, log=print) -> dict:
    """Run one seeded soak; returns the report dict (see module doc)."""
    # children (raylets, GCS, workers) inherit the switch; the driver's
    # own plane stays consulted-but-unarmed (crash rules never match
    # proc="driver" in the schedule below). Restored on exit: leaking
    # the switch into the host process flips fault-plane behavior for
    # whatever runs next (e.g. later tests in one pytest process).
    env_prev = {k: os.environ.get(k)
                for k in ("RAY_TPU_FAULT_INJECTION_ENABLED",
                          "RAY_TPU_FAULT_INJECTION_SEED")}
    os.environ["RAY_TPU_FAULT_INJECTION_ENABLED"] = "1"
    os.environ.setdefault("RAY_TPU_FAULT_INJECTION_SEED", str(seed))

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime import fault_injection as fi
    from ray_tpu_torch.utils.exceptions import ActorError

    classes = tuple(classes)
    rng = random.Random(seed)
    report: dict = {"bench": "chaos_soak", "seed": seed,
                    "duration_s": duration_s, "classes": list(classes)}
    violations: list[dict] = []

    cluster = Cluster(heartbeat_timeout_s=2.0, gcs_fault_tolerance=True,
                      external_gcs=("gcs" in classes))
    try:
        cluster.add_node(num_cpus=8)
        n_nodes = 1
        if "raylet" in classes:
            # the head's in-process raylet keeps the driver label and is
            # exempt from proc="raylet" rules; tag the external nodes
            # with a capacity the head lacks so a slice of the workload
            # MUST lease there — raylet.before_lease_grant is then
            # evaluated continuously on a killable raylet and the
            # raylet fault class fires deterministically in its window
            cluster.add_node(num_cpus=4, external=True,
                             resources={"ext": 4})
            cluster.add_node(num_cpus=4, external=True,
                             resources={"ext": 4})
            n_nodes = 3
        cluster.wait_for_nodes(n_nodes, timeout=30)
        cluster.start_supervisor(poll_s=0.2)
        ray_tpu_torch.init(address=cluster.gcs_address)

        soak_task = ray_tpu_torch.remote(_soak_task)
        SoakCounter = ray_tpu_torch.remote(_SoakCounter)
        SoakEcho = serve.deployment(num_replicas=serve_replicas,
                                    max_concurrent_queries=8,
                                    name="SoakEcho")(_SoakEcho)

        handle = serve.run(SoakEcho.bind())
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")

        stop = threading.Event()
        ledgers = {"tasks": _Workload("tasks"),
                   "actor": _Workload("actor"),
                   "serve": _Workload("serve")}
        if "raylet" in classes:
            ledgers["tasks_ext"] = _Workload("tasks_ext")

        def classify(led: _Workload, t0: float, err: BaseException):
            led.record(t0, time.time(), ok=False, error=err)

        def tasks_loop():
            i = 0
            led = ledgers["tasks"]
            while not stop.is_set():
                t0 = time.time()
                try:
                    out = ray_tpu_torch.get(soak_task.remote(i),
                                      timeout=get_timeout_s)
                    led.record(t0, time.time(), ok=(out == i * 2))
                except Exception as e:  # noqa: BLE001 - ledger classifies
                    classify(led, t0, e)
                i += 1
                stop.wait(0.05)

        def tasks_ext_loop():
            # external-pinned slice: {"ext"} only exists on the external
            # raylets, so every lap grants a lease on one of them — the
            # workload that proves the raylet fault class fires and that
            # leases flow again after the supervisor respawn
            i = 0
            led = ledgers["tasks_ext"]
            ext_task = soak_task.options(resources={"ext": 1})
            while not stop.is_set():
                t0 = time.time()
                try:
                    out = ray_tpu_torch.get(ext_task.remote(i),
                                      timeout=get_timeout_s)
                    led.record(t0, time.time(), ok=(out == i * 2))
                except Exception as e:  # noqa: BLE001 - ledger classifies
                    classify(led, t0, e)
                i += 1
                stop.wait(0.05)

        def actor_loop():
            led = ledgers["actor"]
            actor = SoakCounter.remote()
            while not stop.is_set():
                t0 = time.time()
                try:
                    ray_tpu_torch.get(actor.bump.remote(),
                                timeout=get_timeout_s)
                    led.record(t0, time.time(), ok=True)
                except ActorError as e:
                    # typed death: replace the actor and keep going —
                    # exactly what a supervisor-style app would do
                    classify(led, t0, e)
                    try:
                        actor = SoakCounter.remote()
                    except Exception:  # noqa: BLE001 - retried next lap
                        pass
                except Exception as e:  # noqa: BLE001
                    classify(led, t0, e)
                stop.wait(0.1)

        def serve_loop():
            led = ledgers["serve"]
            i = 0
            stream_handle = handle.options(method_name="chunks")
            while not stop.is_set():
                t0 = time.time()
                try:
                    if i % 5 == 4:
                        got = list(stream_handle.stream(3))
                        led.record(t0, time.time(), ok=(got == [0, 1, 2]))
                    else:
                        out = handle.call(i)
                        led.record(t0, time.time(),
                                   ok=(out == {"echo": i}))
                except Exception as e:  # noqa: BLE001
                    classify(led, t0, e)
                i += 1
                stop.wait(0.1)

        loops = [("soak-tasks", tasks_loop),
                 ("soak-actor", actor_loop),
                 ("soak-serve", serve_loop)]
        if "tasks_ext" in ledgers:
            loops.append(("soak-tasks-ext", tasks_ext_loop))
        threads = [threading.Thread(target=fn, daemon=True, name=name)
                   for name, fn in loops]
        for t in threads:
            t.start()

        # the GCS log store is rebuilt empty on a crash-restart (error
        # groups are not WAL'd), so a crash group harvested before the
        # run's last GCS death is gone by the final check — poll live
        # and latch the sighting instead
        crash_group_live = threading.Event()

        def crash_group_poll():
            from ray_tpu_torch.util import state as state_api
            while not stop.is_set():
                try:
                    if any(g.get("kind") == "crash"
                           for g in state_api.summarize_errors()):
                        crash_group_live.set()
                        return
                except Exception:  # noqa: BLE001 - GCS mid-restart
                    pass
                stop.wait(2.0)

        poller = threading.Thread(target=crash_group_poll, daemon=True,
                                  name="soak-crash-group-poll")
        poller.start()

        # warm up, then baseline the leak counters
        time.sleep(3.0)
        fd0, threads0 = _fd_count(), threading.active_count()

        # -- seeded injection schedule ---------------------------------
        version = 1
        injections: list[dict] = []
        fault_menu = list(classes) + (["partition"] if partitions else [])

        def put(rules, *, attempts=20):
            nonlocal version
            version += 1
            plan = {"version": version, "seed": seed, "rules": rules}
            last = None
            for _ in range(attempts):
                try:
                    fi.put_plan(cluster.gcs_address, plan)
                    return True
                except Exception as e:  # noqa: BLE001 - GCS mid-restart
                    last = e
                    time.sleep(0.5)
            log(f"[soak] plan write failed after retries: {last!r}")
            return False

        t_end = time.monotonic() + duration_s
        while time.monotonic() < t_end - max(6.0, inject_period_s):
            cls = rng.choice(fault_menu)
            t0 = time.time()
            ev = {"class": cls, "t": t0, "recovered_s": None}
            if cls == "partition":
                # the metrics push channel's cut (observability
                # degrades, conservation must not)
                put([{"id": "soak-cut-metrics", "fault": "partition",
                      "src": "metrics", "dst": "gcs",
                      "direction": "both"}])
                time.sleep(rng.uniform(1.0, 2.5))
                put([])
            else:
                put(list(_CLASS_RULES[cls]))
                # the window: processes that reach the point die once
                time.sleep(rng.uniform(1.5, 3.0))
                # clear; for the gcs class this very write IS the
                # trigger (WAL append → crash before reply), so it can
                # raise — the retry loop rides out the restart
                put([])
            injections.append(ev)
            log(f"[soak] injected {cls} at +"
                f"{duration_s - (t_end - time.monotonic()):.0f}s")
            # let the dust settle so per-class recoveries attribute to
            # the right injection
            time.sleep(max(0.0, inject_period_s - 3.0)
                       * rng.uniform(0.8, 1.2))

        # make sure no crash rules stay armed, then drain
        put([])
        settle = min(20.0, max(10.0, get_timeout_s / 2))
        time.sleep(settle)
        stop.set()
        # "wedged" must mean UNBOUNDED, not merely slow: a call racing
        # the last injection can legitimately sit in actor-location
        # resolve for up to actor_resolve_timeout_s before it surfaces
        # typed, so the join window sizes past the system's worst-case
        # bounded resolution latency (join returns early when threads
        # finish, which is the common case)
        from ray_tpu_torch.utils.config import get_config as _gc
        join_s = max(get_timeout_s + 10,
                     _gc().actor_resolve_timeout_s + 30)
        for t in threads:
            t.join(timeout=join_s)
        wedged_threads = [t.name for t in threads if t.is_alive()]
        # a wedged workload is the invariant failure this harness
        # exists to catch — capture WHERE it is stuck so the report is
        # actionable, not just red
        wedge_stacks: dict[str, list[str]] = {}
        if wedged_threads:
            import traceback
            frames = sys._current_frames()
            for t in threads:
                if t.is_alive() and t.ident in frames:
                    wedge_stacks[t.name] = [
                        ln.strip() for ln in traceback.format_stack(
                            frames[t.ident])[-8:]]

        # -- MTTR accounting -------------------------------------------
        per_class: dict[str, dict] = {}
        failover = ray_tpu_torch.get(controller.failover_stats.remote(),
                               timeout=20)
        replica_mttrs = [e["replaced_at"] - e["detected_at"]
                         for e in failover["events"]
                         if e.get("replaced_at")]
        cluster_events = list(cluster.crash_events)
        raylet_mttrs = [e["recovered_at"] - e["detected_at"]
                        for e in cluster_events if e["class"] == "raylet"]
        gcs_mttrs = [e["recovered_at"] - e["detected_at"]
                     for e in cluster_events if e["class"] == "gcs"]
        service_ledger = {"worker": "tasks", "replica": "serve",
                          "raylet": "tasks_ext"}
        for ev in injections:
            led = ledgers.get(service_ledger.get(ev["class"]))
            if led is not None:
                ok_at = led.first_ok_after(ev["t"])
                if ok_at is not None:
                    ev["recovered_s"] = ok_at - ev["t"]
        for cls in classes:
            evs = [e for e in injections if e["class"] == cls]
            service = [e["recovered_s"] for e in evs
                       if e["recovered_s"] is not None]
            entry = {"injections": len(evs),
                     "service_mttr_s": service}
            if cls == "replica":
                entry["replace_mttr_s"] = replica_mttrs
            if cls == "raylet":
                entry["respawn_mttr_s"] = raylet_mttrs
            if cls == "gcs":
                entry["restart_mttr_s"] = gcs_mttrs
            for key in ("service_mttr_s", "replace_mttr_s",
                        "respawn_mttr_s", "restart_mttr_s"):
                vals = entry.get(key)
                if vals:
                    entry[key.replace("_s", "_mean_s")] = (
                        sum(vals) / len(vals))
                    entry[key.replace("_s", "_max_s")] = max(vals)
            per_class[cls] = entry

        # -- invariants ------------------------------------------------
        for name, led in ledgers.items():
            for op in led.untyped():
                violations.append({"invariant": "typed_errors",
                                   "workload": name, **op})
        for name in wedged_threads:
            violations.append({"invariant": "no_wedged_workloads",
                               "workload": name,
                               "stack": wedge_stacks.get(name)})
        if "raylet" in classes and not raylet_mttrs and any(
                e["class"] == "raylet" for e in injections):
            violations.append({"invariant": "raylet_respawned",
                               "detail": "no supervisor respawn event"})
        if "gcs" in classes and not gcs_mttrs and any(
                e["class"] == "gcs" for e in injections):
            violations.append({"invariant": "gcs_restarted",
                               "detail": "no supervisor restart event"})
        if "replica" in classes and any(
                e["class"] == "replica" for e in injections):
            if not failover["events"]:
                violations.append({
                    "invariant": "replica_replaced",
                    "detail": "controller recorded no failover events"})

        fd1, threads1 = _fd_count(), threading.active_count()
        fd_delta = (fd1 - fd0) if fd0 >= 0 and fd1 >= 0 else 0
        thread_delta = threads1 - threads0
        if fd_delta > 64:
            violations.append({"invariant": "no_fd_leak",
                               "delta": fd_delta})
        if thread_delta > 16:
            violations.append({"invariant": "no_thread_leak",
                               "delta": thread_delta})

        # last words: an injected death's crash marker reaches the log
        # plane as a 'crash' error group; the in-process raylets' death
        # info names the crash points too (reported beside it)
        from ray_tpu_torch.util import state as state_api

        planes = {"crash_points_harvested": sorted({
            info["crash_point"]
            for h in cluster.nodes.values() if h.raylet is not None
            for info in list(h.raylet.workers._death_info.values())
            if info.get("crash_point")})}
        try:
            errs = state_api.summarize_errors()
            planes["log"] = isinstance(errs, list)
            planes["crash_group_seen"] = (
                any(g.get("kind") == "crash" for g in errs)
                or crash_group_live.is_set())
        except Exception as e:  # noqa: BLE001
            planes["log"] = False
            violations.append({"invariant": "planes_intact",
                               "plane": "log", "detail": repr(e)[:200]})
        try:
            planes["metrics"] = isinstance(
                state_api.cluster_metrics(), dict)
        except Exception as e:  # noqa: BLE001
            planes["metrics"] = False
            violations.append({"invariant": "planes_intact",
                               "plane": "metrics",
                               "detail": repr(e)[:200]})
        crash_injected = any(e["class"] in ("worker", "replica")
                             for e in injections)
        if crash_injected and not planes.get("crash_group_seen"):
            violations.append({
                "invariant": "crash_last_words_harvested",
                "detail": "no 'crash' group in summarize_errors()"})

        report.update({
            "injections": injections,
            "per_class": per_class,
            "workloads": {n: led.summary()
                          for n, led in ledgers.items()},
            "replica_failover": failover,
            "cluster_events": [
                {k: v for k, v in e.items() if k != "last_words"}
                for e in cluster_events],
            "fd_delta": fd_delta, "thread_delta": thread_delta,
            "planes": planes,
            "violations": violations,
            "chaos_soak_invariant_violations": len(violations),
        })
        # flat gate metrics (the JAX package's CI ceilings read the same keys)
        rep = per_class.get("replica", {})
        ray_cls = per_class.get("raylet", {})
        if rep.get("replace_mttr_mean_s") is not None:
            report["chaos_mttr_replica_mean_s"] = rep[
                "replace_mttr_mean_s"]
        if ray_cls.get("respawn_mttr_mean_s") is not None:
            report["chaos_mttr_raylet_mean_s"] = ray_cls[
                "respawn_mttr_mean_s"]
        return report
    finally:
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001
            pass
        try:
            ray_tpu_torch.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()
        try:
            fi.stop_kv_watcher()
            fi.plane.clear()
        except Exception:  # noqa: BLE001
            pass
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
