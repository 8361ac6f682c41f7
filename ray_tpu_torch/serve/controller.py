"""Serve controller: declarative deployment state reconciliation.

Port of ``ray_tpu/serve/controller.py`` on the port's in-process runtime.
Reference analog: ``serve/_private/controller.py`` (``ServeController:87``,
``run_control_loop:312``) + ``deployment_state.py`` (``DeploymentState
:1149`` — diff target vs actual replica sets) + autoscaling policy
(``_private/autoscaling_policy.py``). The controller is a named actor; a
background thread reconciles desired replica counts and drives
autoscaling from replica queue metrics.

The deployment body reaches its replicas as stdlib ``pickle`` bytes (JAX:
cloudpickle), carried by qualified name: a module-level class or function,
or a ``functools.partial`` of one (``serve/api.py`` ``dump_body``).
Autoscaling is the polled policy (``metrics()`` of every replica), the one
the JAX package falls back to when its metrics plane is dark; the
metrics-driven policy, the ongoing-requests gauge and the log plane's
labels wait for their planes. The replicas' fault-injection crash points
(``replica.mid_request``, ``replica.mid_decode``) are JAX's, and
``deployment_meta`` tells the HTTP proxy which deployments are ASGI
ingresses (``serve/ingress.py``).
"""

from __future__ import annotations

import pickle
import threading
import time

from ray_tpu_torch import api


class _Replica:
    """Replica actor body: wraps the user's deployment class.

    Reference analog: ``serve/_private/replica.py`` — handle_request:227.
    Requests run on the actor's concurrency pool; ``num_ongoing`` feeds
    both the router's p2c choice and controller autoscaling."""

    def __init__(self, cls_blob, init_args, init_kwargs, user_config,
                 deployment=None, replica_tag=None):
        from ray_tpu_torch.serve.context import set_replica_context

        self._deployment = deployment or "-"
        self._tag = replica_tag or f"replica-{id(self) & 0xffffff:06x}"
        # context must be installed on THIS thread before the user class
        # constructs: engines read it in __init__ to tag their prefix
        # digests
        set_replica_context(self._deployment, self._tag)
        cls = pickle.loads(cls_blob)
        init_args = [self._resolve_refs(a) for a in init_args]
        init_kwargs = {k: self._resolve_refs(v)
                       for k, v in init_kwargs.items()}
        self._instance = cls(*init_args, **init_kwargs)
        if user_config and hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)
        self._ongoing = 0
        self._lock = threading.Lock()
        self._total = 0
        self._streams: dict = {}
        self._stream_errors: dict = {}

    @staticmethod
    def _resolve_refs(value):
        """DeploymentRef placeholders (deployment-graph composition)
        become live handles inside the replica."""
        from ray_tpu_torch.serve.api import (DeploymentRef,
                                             get_deployment_handle)

        if isinstance(value, DeploymentRef):
            return get_deployment_handle(value.name)
        if isinstance(value, tuple):
            walked = [_Replica._resolve_refs(v) for v in value]
            # namedtuples construct positionally, not from an iterable
            return (type(value)(*walked) if hasattr(value, "_fields")
                    else tuple(walked))
        if isinstance(value, list):
            return [_Replica._resolve_refs(v) for v in value]
        if isinstance(value, dict):
            return {k: _Replica._resolve_refs(v)
                    for k, v in value.items()}
        return value

    async def handle_request(self, method_name, args, kwargs):
        """ASYNC handler: replicas are asyncio actors (the coroutine here
        puts the hosting worker in async mode), so up to
        max_concurrent_queries requests overlap — async deployment
        methods at await points, and SYNC handlers in a thread executor (the reference replica runs sync user code in a
        thread pool too; a deployment that needs strictly serial
        execution sets max_concurrent_queries=1)."""
        import inspect

        from ray_tpu_torch.serve.multiplex import (MODEL_ID_KWARG,
                                                   set_request_model_id)

        model_id = kwargs.pop(MODEL_ID_KWARG, None)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        token = set_request_model_id(model_id)
        try:
            from ray_tpu_torch.runtime import fault_injection as _fi

            # crash point: request admitted and counted in-flight — the
            # router must fail callers typed-fast and the controller's
            # health probes must replace this replica (chaos replica class)
            _fi.maybe_crash("replica.mid_request")
            target = (self._instance if method_name == "__call__"
                      else getattr(self._instance, method_name))
            fn = target if (inspect.isfunction(target)
                            or inspect.ismethod(target)) \
                else getattr(target, "__call__", target)
            if inspect.iscoroutinefunction(fn):
                result = await target(*args, **kwargs)
            else:
                # SYNC handler: off the loop (reference: replica runs
                # sync user code in a thread executor) — a blocking
                # model call must not freeze the metrics/other requests
                import asyncio
                import contextvars
                import functools as _ft

                # copy_context: executor threads don't inherit this
                # coroutine's contextvars (the multiplex model id rides
                # on one)
                ctx = contextvars.copy_context()
                result = await asyncio.get_running_loop().run_in_executor(
                    None, _ft.partial(ctx.run, target, *args, **kwargs))
                if inspect.isawaitable(result):
                    # sync wrapper returned a coroutine (e.g. a
                    # @serve.batch-wrapped call): drive it here
                    result = await result
            return result
        finally:
            from ray_tpu_torch.serve.multiplex import _request_model_id

            _request_model_id.reset(token)
            with self._lock:
                self._ongoing -= 1

    # -- streaming (reference: replica.py handle_request_streaming:323) --

    def start_stream(self, method_name, args, kwargs) -> str:
        """Run a generator method; chunks buffer in a per-stream queue
        drained by next_chunks() calls from the handle. An abandoned
        stream (no consumer drain for 60s against a full queue) tears
        itself down so threads/metrics don't leak."""
        import queue as _q
        import uuid

        from ray_tpu_torch.serve.multiplex import (MODEL_ID_KWARG,
                                                   set_request_model_id)

        model_id = kwargs.pop(MODEL_ID_KWARG, None)
        stream_id = uuid.uuid4().hex[:16]
        q: "_q.Queue" = _q.Queue(maxsize=64)
        with self._lock:
            self._streams[stream_id] = q
            self._ongoing += 1
            self._total += 1

        def pump():
            from ray_tpu_torch.runtime import fault_injection as _fi

            token = set_request_model_id(model_id)
            try:
                target = (self._instance if method_name == "__call__"
                          else getattr(self._instance, method_name))
                for chunk in target(*args, **kwargs):
                    # crash point: mid-stream, chunks already delivered —
                    # the consumer's next_chunks call must fail typed-
                    # fast, not hang out a redial window
                    _fi.maybe_crash("replica.mid_decode")
                    q.put(("chunk", chunk), timeout=60.0)
                q.put(("end", None), timeout=60.0)
            except _q.Full:  # consumer gone: abandon the stream
                with self._lock:
                    self._streams.pop(stream_id, None)
            except BaseException as e:  # noqa: BLE001 - ship to consumer
                try:
                    q.put(("error", e), timeout=60.0)
                except _q.Full:
                    with self._lock:
                        self._streams.pop(stream_id, None)
            finally:
                from ray_tpu_torch.serve.multiplex import _request_model_id

                _request_model_id.reset(token)
                with self._lock:
                    self._ongoing -= 1

        threading.Thread(target=pump, daemon=True).start()
        return stream_id

    async def next_chunks(self, stream_id: str, max_chunks: int = 16,
                          timeout_s: float = 10.0):
        """Up to max_chunks buffered items; final state signals end. A
        generator error is delivered AFTER its preceding chunks: chunks
        already accumulated return normally and the error re-raises on
        the next call. ASYNC wrapper: the blocking queue wait runs in
        the executor in SHORT slices — a long poll parking an executor
        thread for its full timeout would let a handful of idle streams
        starve the shared pool that sync handlers also use."""
        import asyncio
        import functools as _ft
        import time as _time

        loop = asyncio.get_running_loop()
        deadline = _time.monotonic() + timeout_s
        while True:
            slice_s = min(0.25, max(deadline - _time.monotonic(), 0.0))
            result = await loop.run_in_executor(
                None, _ft.partial(self._next_chunks_sync, stream_id,
                                  max_chunks, slice_s))
            if result[0] != "pending" or result[1]:
                return result
            if _time.monotonic() >= deadline:
                return result

    def _next_chunks_sync(self, stream_id: str, max_chunks: int,
                          timeout_s: float):
        import queue as _q

        pending_err = self._stream_errors.pop(stream_id, None)
        if pending_err is not None:
            with self._lock:
                self._streams.pop(stream_id, None)
            raise pending_err
        q = self._streams.get(stream_id)
        if q is None:
            raise KeyError(f"unknown stream {stream_id}")
        out = []
        try:
            kind, payload = q.get(timeout=timeout_s)
        except _q.Empty:
            return ("pending", out)
        while True:
            if kind == "chunk":
                out.append(payload)
            elif kind == "error":
                if out:
                    # deliver data first; error surfaces next call
                    self._stream_errors[stream_id] = payload
                    return ("more", out)
                with self._lock:
                    self._streams.pop(stream_id, None)
                raise payload
            else:  # end
                with self._lock:
                    self._streams.pop(stream_id, None)
                return ("end", out)
            if len(out) >= max_chunks:
                return ("more", out)
            try:
                kind, payload = q.get_nowait()
            except _q.Empty:
                return ("more", out)

    async def reconfigure(self, user_config):
        # off the loop: user reconfigure code may block (model reload)
        import asyncio

        def apply():
            if hasattr(self._instance, "reconfigure"):
                self._instance.reconfigure(user_config)
            return True

        return await asyncio.get_running_loop().run_in_executor(None, apply)

    def metrics(self):
        with self._lock:
            return {"ongoing": self._ongoing, "total": self._total}

    def replica_tag(self) -> str:
        return self._tag

    def multiplexed_model_ids(self) -> list:
        from ray_tpu_torch.serve.multiplex import loaded_model_ids

        return loaded_model_ids(self._instance)

    def ping(self):
        return True

    def drain(self):
        """Scale-down prep: retract this replica's prefix digest so the
        affinity router stops steering new prefixes here, and report the
        in-flight count the controller waits on before killing us. The
        route-table version bump already stopped new admissions; any
        straggler from a stale table still gets served."""
        from ray_tpu_torch.runtime import annex
        annex.set_annex(f"serve/prefix_digest/{self._tag}", None)
        with self._lock:
            return self._ongoing


class ServeController:
    """Named actor ('SERVE_CONTROLLER'). Deployment lifecycle + replica
    sets + autoscaling."""

    def __init__(self):
        self._deployments: dict[str, dict] = {}
        self._lock = threading.RLock()
        self._stop = False
        self._version = 0
        # multiplexed model-id sets are POLLED here (throttled, off the
        # request path) and PUSHED to handles inside the routing table,
        # replacing each handle's own per-request 1s-TTL replica sweep
        self._models_polled_at = 0.0
        # proactive failover: periodic replica health probes; each
        # detected death is recorded for MTTR accounting and stamped
        # replaced_at when the reconciler admits the replacement
        self._probed_at = 0.0
        self._probes = 0
        self._crash_events: list[dict] = []
        self._loop = threading.Thread(target=self._control_loop, daemon=True)
        self._loop.start()

    # -- deployment API --------------------------------------------------
    @staticmethod
    def _same_spec(prev, cls_blob, init_args, init_kwargs,
                   config) -> bool:
        """True when only the replica COUNT differs: that is a scale
        event (graceful drain / spawn), not a code change, and must not
        tear down live replicas. Unpicklable/odd arg objects fail the
        comparison and fall back to the redeploy path (conservative)."""
        try:
            strip = lambda c: {k: v for k, v in c.items()  # noqa: E731
                               if k != "num_replicas"}
            return (prev["cls_blob"] == cls_blob
                    and prev["init_args"] == init_args
                    and prev["init_kwargs"] == init_kwargs
                    and strip(prev["config"]) == strip(config))
        except Exception:  # noqa: BLE001 - uncomparable: full redeploy
            return False

    def deployment_meta(self, name: str) -> dict:
        """Static facts the proxies need (e.g. whether the deployment is
        an ASGI ingress, which switches the HTTP proxy to raw-request
        forwarding)."""
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None:
                return {}
            return {"asgi": bool(dep["config"].get("asgi"))}

    def deploy(self, name: str, cls_blob: bytes, init_args, init_kwargs,
               config: dict):
        with self._lock:
            prev = self._deployments.get(name)
            self._deployments[name] = {
                "cls_blob": cls_blob,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "config": config,
                "replicas": prev["replicas"] if prev else [],
                "tags": prev["tags"] if prev else [],
                "models": prev["models"] if prev else {},
                "next_idx": prev["next_idx"] if prev else 0,
                "draining": prev.get("draining", []) if prev else [],
                "replaced": prev.get("replaced", 0) if prev else 0,
                "probe_failures": {},
                "autoscale_mode": None,
                "target": (config.get("autoscaling") or {}).get(
                    "min_replicas", config.get("num_replicas", 1))
                if config.get("autoscaling")
                else config.get("num_replicas", 1),
                "last_scale": time.monotonic(),
                "redeploy": prev is not None and not self._same_spec(
                    prev, cls_blob, init_args, init_kwargs, config),
            }
            self._version += 1
        return True

    def delete_deployment(self, name: str):
        with self._lock:
            dep = self._deployments.pop(name, None)
            self._version += 1
        if dep:
            for r in dep["replicas"]:
                _kill_quietly(r)
            for ent in dep.get("draining", ()):
                _kill_quietly(ent["replica"])
        return True

    def get_replicas(self, name: str):
        """(version, [replica handles]) — handles are routable actor refs."""
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None:
                return self._version, None
            return self._version, list(dep["replicas"])

    def get_routing_table(self, name: str):
        """(version, [{replica, tag, models}]) — the handle-facing route
        set: actor handles plus stable replica tags (prefix-affinity
        routing keys into these) and each replica's multiplexed
        model-id set (pushed model map — handles no longer sweep
        replicas themselves; the table invalidates on version bumps)."""
        with self._lock:
            dep = self._deployments.get(name)
            if dep is None:
                return self._version, None
            models = dep["models"]
            return self._version, [
                {"replica": r, "tag": t, "models": models.get(t, [])}
                for r, t in zip(dep["replicas"], dep["tags"])]

    def version(self) -> int:
        return self._version

    def list_deployments(self):
        with self._lock:
            return {
                name: {"target": dep["target"],
                       "running": len(dep["replicas"]),
                       "autoscale_mode": dep.get("autoscale_mode"),
                       "config": dep["config"]}
                for name, dep in self._deployments.items()
            }

    def shutdown(self):
        self._stop = True
        with self._lock:
            deps = list(self._deployments.values())
            self._deployments.clear()
        for dep in deps:
            for r in dep["replicas"]:
                _kill_quietly(r)
            for ent in dep.get("draining", ()):
                _kill_quietly(ent["replica"])
        return True

    def failover_stats(self):
        """Replica-failover accounting for the chaos soak's MTTR: one
        event per probed-out replica with detection and replacement
        timestamps, plus per-deployment replacement totals."""
        with self._lock:
            return {
                "events": [dict(e) for e in self._crash_events],
                "replaced": {n: d.get("replaced", 0)
                             for n, d in self._deployments.items()},
                "draining": {n: len(d.get("draining", ()))
                             for n, d in self._deployments.items()},
                "probes": self._probes,
            }

    # -- reconciliation --------------------------------------------------
    def _control_loop(self):
        while not self._stop:
            try:
                self._reconcile_once()
                self._drain_once()
                self._health_probe_once()
                self._poll_models_once()
                self._autoscale_once()
            except Exception:  # noqa: BLE001 - keep the loop alive
                pass
            time.sleep(0.1)

    def _reconcile_once(self):
        with self._lock:
            items = list(self._deployments.items())
        for name, dep in items:
            if dep.get("redeploy"):
                # config/code changed: replace replica set (reference:
                # rolling update; v1 does stop-then-start)
                old = dep["replicas"]
                dep["replicas"] = []
                dep["tags"] = []
                dep["models"] = {}
                dep["redeploy"] = False
                for r in old:
                    _kill_quietly(r)
                with self._lock:
                    self._version += 1
            target = dep["target"]
            replicas = dep["replicas"]
            while len(replicas) < target:
                replica_cls = api.remote(_Replica)
                res = dep["config"].get("resources_per_replica") or {}
                opts = {"max_concurrency":
                        dep["config"].get("max_concurrent_queries", 8)}
                if res.get("CPU"):
                    opts["num_cpus"] = res["CPU"]
                if res.get("GPU"):
                    opts["num_gpus"] = res["GPU"]
                tag = f"{name}#r{dep['next_idx']}"
                dep["next_idx"] += 1
                handle = replica_cls.options(**opts).remote(
                    dep["cls_blob"], dep["init_args"], dep["init_kwargs"],
                    dep["config"].get("user_config") or {},
                    deployment=name, replica_tag=tag)
                replicas.append(handle)
                dep["tags"].append(tag)
                with self._lock:
                    self._version += 1
                    # a spawn while crash events are pending IS the
                    # replacement: stamp the oldest unreplaced one
                    for ev in self._crash_events:
                        if (ev["deployment"] == name
                                and ev["replaced_at"] is None):
                            ev["replaced_at"] = time.time()
                            break
            while len(replicas) > target:
                # graceful scale-down: unpublish the route first (the
                # version bump stops new admissions), let in-flight
                # requests finish; _drain_once kills when ongoing hits
                # zero or the drain deadline passes
                victim = replicas.pop()
                tag = dep["tags"].pop() if dep["tags"] else None
                dep["models"].pop(tag, None)
                dep.setdefault("draining", []).append(
                    {"replica": victim, "tag": tag,
                     "since": time.monotonic(), "drained": False})
                with self._lock:
                    self._version += 1

    def _drain_once(self):
        from ray_tpu_torch.utils import exceptions
        from ray_tpu_torch.utils.config import get_config
        cfg = get_config()
        with self._lock:
            items = list(self._deployments.items())
        for _name, dep in items:
            keep = []
            for ent in dep.get("draining", ()):
                r = ent["replica"]
                try:
                    if not ent["drained"]:
                        # one-shot: retract the prefix digest, get the
                        # in-flight count to wait on
                        ongoing = api.get(r.drain.remote(), timeout=2)
                        ent["drained"] = True
                    else:
                        ongoing = api.get(
                            r.metrics.remote(), timeout=2)["ongoing"]
                except exceptions.ActorError:
                    ongoing = 0    # already dead: reap the handle
                except Exception:  # noqa: BLE001 - busy/slow, NOT dead
                    # a replica mid-request can miss the poll timeout;
                    # only the drain deadline may condemn it
                    ongoing = 1
                deadline = ent["since"] + cfg.serve_drain_timeout_s
                if ongoing <= 0 or time.monotonic() > deadline:
                    _kill_quietly(r)
                else:
                    keep.append(ent)
            dep["draining"] = keep

    def _health_probe_once(self):
        """Proactively ping every replica; replace ones that died
        instead of waiting for a request to trip over the corpse. A
        typed actor-death error is immediate; bare timeouts must repeat
        ``serve_health_probe_failures`` times (a busy replica is slow,
        not dead)."""
        from ray_tpu_torch.utils import exceptions as exc
        from ray_tpu_torch.utils.config import get_config
        cfg = get_config()
        if not cfg.serve_health_probing_enabled:
            return
        now = time.monotonic()
        if now - self._probed_at < cfg.serve_health_probe_period_s:
            return
        self._probed_at = now
        with self._lock:
            items = list(self._deployments.items())
        for name, dep in items:
            fails = dep.setdefault("probe_failures", {})
            for r, tag in list(zip(dep["replicas"], dep["tags"])):
                dead = False
                self._probes += 1
                try:
                    api.get(r.ping.remote(),
                                timeout=cfg.serve_health_probe_timeout_s)
                    fails.pop(tag, None)
                except exc.ActorError:
                    dead = True
                except Exception:  # noqa: BLE001 - timeout/transport
                    fails[tag] = fails.get(tag, 0) + 1
                    dead = fails[tag] >= cfg.serve_health_probe_failures
                if dead:
                    self._bury_replica(name, dep, r, tag)

    def _bury_replica(self, name: str, dep: dict, replica, tag):
        """Drop a crashed replica from the route set NOW (the version
        bump makes stale handles re-pull and fail in-flight calls fast)
        and leave len(replicas) < target for the reconciler to refill."""
        with self._lock:
            try:
                i = dep["tags"].index(tag)
            except ValueError:
                return    # already buried by a racing path
            dep["replicas"].pop(i)
            dep["tags"].pop(i)
            dep["models"].pop(tag, None)
            dep.setdefault("probe_failures", {}).pop(tag, None)
            dep["replaced"] = dep.get("replaced", 0) + 1
            self._version += 1
            self._crash_events.append({
                "deployment": name, "tag": tag,
                "detected_at": time.time(), "replaced_at": None})
        _kill_quietly(replica)

    def _poll_models_once(self, interval_s: float = 0.25):
        """Refresh each replica's multiplexed model-id set (throttled).
        Changes bump the routing-table version, so handles re-pull the
        pushed model map instead of sweeping replicas per request."""
        now = time.monotonic()
        if now - self._models_polled_at < interval_s:
            return
        self._models_polled_at = now
        with self._lock:
            items = list(self._deployments.items())
        for name, dep in items:
            pairs = list(zip(dep["replicas"], dep["tags"]))
            models = {}
            for r, t in pairs:
                try:
                    models[t] = sorted(api.get(
                        r.multiplexed_model_ids.remote(), timeout=2))
                except Exception:  # noqa: BLE001 - dead replica: keep last
                    models[t] = dep["models"].get(t, [])
            if models != dep["models"]:
                dep["models"] = models
                with self._lock:
                    self._version += 1

    def _autoscale_once(self):
        """The polled policy: scale on the mean of the replicas' ongoing
        requests (reference: ``_private/autoscaling_policy.py``)."""
        now = time.monotonic()
        with self._lock:
            items = list(self._deployments.items())
        for name, dep in items:
            auto = dep["config"].get("autoscaling")
            if not auto or not dep["replicas"]:
                continue
            n = len(dep["replicas"])
            dep["autoscale_mode"] = "polled"
            try:
                metrics = api.get(
                    [r.metrics.remote() for r in dep["replicas"]],
                    timeout=5)
            except Exception:  # noqa: BLE001
                continue
            per_replica = sum(m["ongoing"] for m in metrics) / n
            target_per = auto.get("target_ongoing_requests", 2.0)
            if (per_replica > target_per
                    and dep["target"] < auto.get("max_replicas", 4)
                    and now - dep["last_scale"] > auto.get(
                        "upscale_delay_s", 0.5)):
                dep["target"] += 1
                dep["last_scale"] = now
            elif (per_replica < target_per / 2
                    and dep["target"] > auto.get("min_replicas", 1)
                    and now - dep["last_scale"] > auto.get(
                        "downscale_delay_s", 2.0)):
                dep["target"] -= 1
                dep["last_scale"] = now


def _kill_quietly(handle):
    try:
        api.kill(handle)
    except Exception:  # noqa: BLE001
        pass
