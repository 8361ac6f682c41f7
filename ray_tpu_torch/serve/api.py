"""Serve public API: @deployment / run / batch / HTTP proxy.

Port of ``ray_tpu/serve/api.py`` on the port's runtimes: in-process, or a
cluster (``init(address=...)``), where the controller is a detached actor
and each replica an actor in its own worker process, while handles and the
HTTP proxy stay in the driver.
Reference analog: ``serve/api.py`` (``@serve.deployment:256``,
``serve.run:463``), ``serve/batching.py`` (``@serve.batch:65`` dynamic
batching), and the per-node HTTP proxy (``_private/proxy.py:759`` — here a
threaded stdlib HTTP server routing JSON bodies to deployment handles,
keeping the data path dependency-free).

The deployment body reaches the controller and its replicas as stdlib
``pickle`` bytes (``dump_body``), where the JAX package uses cloudpickle:
pickle carries a class or function by its qualified name, and one of the
driver's ``__main__`` by its file path (``runtime/serialization.py``),
which a worker process imports as ``__mp_main__``. A class that
``@serve.deployment`` replaced by its ``Deployment`` in its module is
carried by the name it was bound under. A body that pickle cannot carry (a
class or closure defined inside a function) raises with that message. A
deployment wrapped in ``serve.ingress`` (``serve/ingress.py``) is marked
``asgi`` in its config, and the proxy forwards its raw requests (method,
path, query, headers, body) to the replica's ASGI app.
"""

from __future__ import annotations

import functools
import importlib
import io
import json
import pickle
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ray_tpu_torch import api
from ray_tpu_torch.runtime import serialization
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

CONTROLLER_NAME = "SERVE_CONTROLLER"


def _get_or_start_controller():
    try:
        return api.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    controller_cls = api.remote(ServeController)
    try:
        # detached: the serve app outlives the driver that started it
        # (reference: serve's controller runs detached)
        return controller_cls.options(name=CONTROLLER_NAME,
                                      max_concurrency=16,
                                      lifetime="detached").remote()
    except ValueError:  # raced another starter
        return api.get_actor(CONTROLLER_NAME)


def _bound_body(module: str, qualname: str, main_path: str | None = None):
    """The class a module bound under ``qualname`` as a ``Deployment``
    (``main_path``: the module is the driver's main file)."""
    mod = (serialization.import_main(main_path) if main_path
           else importlib.import_module(module))
    return _lookup(mod, qualname)._cls


class _BodyPickler(serialization.Pickler):
    def reducer_override(self, obj):
        # a class or function whose module name now holds its Deployment
        # (``@serve.deployment`` at module level) goes by that name
        mod = getattr(obj, "__module__", None)
        qualname = getattr(obj, "__qualname__", None)
        if callable(obj) and mod and qualname and "<locals>" not in qualname:
            try:
                bound = _lookup(importlib.import_module(mod), qualname)
            except (ImportError, AttributeError):
                bound = None
            if isinstance(bound, Deployment) and bound._cls is obj:
                return _bound_body, (mod, qualname,
                                     serialization.main_module_path(mod))
        return super().reducer_override(obj)


def _lookup(module, qualname: str):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def dump_body(body) -> bytes:
    """``body`` (a deployment's class or function) as stdlib pickle bytes;
    raises ``TypeError`` when pickle cannot carry it."""
    buf = io.BytesIO()
    try:
        _BodyPickler(buf, protocol=5).dump(body)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        name = getattr(body, "__qualname__", repr(body))
        raise TypeError(
            f"the deployment body {name!r} cannot reach its replicas by "
            "pickle: define it at module level (a class, a function, or a "
            "functools.partial of a module-level function); the port "
            f"carries it by stdlib pickle, not cloudpickle ({e})") from e
    return buf.getvalue()


class Deployment:
    """Bound result of @serve.deployment on a class."""

    def __init__(self, cls, name: str, config: DeploymentConfig,
                 init_args=(), init_kwargs=None):
        self._cls = cls
        self.name = name
        self.config = config
        self._init_args = init_args
        self._init_kwargs = init_kwargs or {}

    def options(self, *, name=None, num_replicas=None,
                max_concurrent_queries=None, autoscaling_config=None,
                user_config=None, resources_per_replica=None) -> "Deployment":
        cfg = DeploymentConfig(
            num_replicas=num_replicas or self.config.num_replicas,
            max_concurrent_queries=(max_concurrent_queries
                                    or self.config.max_concurrent_queries),
            autoscaling=autoscaling_config or self.config.autoscaling,
            user_config=user_config or self.config.user_config,
            resources_per_replica=(resources_per_replica
                                   or self.config.resources_per_replica),
        )
        return Deployment(self._cls, name or self.name, cfg,
                          self._init_args, self._init_kwargs)

    def bind(self, *args, **kwargs) -> "Deployment":
        """Bind constructor args (reference: DAG .bind())."""
        return Deployment(self._cls, self.name, self.config, args, kwargs)


def deployment(cls=None, *, name=None, num_replicas=1,
               max_concurrent_queries=8, autoscaling_config=None,
               user_config=None, resources_per_replica=None):
    def wrap(c):
        auto = autoscaling_config
        if isinstance(auto, dict):
            auto = AutoscalingConfig(**auto)
        return Deployment(
            c, name or c.__name__,
            DeploymentConfig(
                num_replicas=num_replicas,
                max_concurrent_queries=max_concurrent_queries,
                autoscaling=auto,
                user_config=user_config or {},
                resources_per_replica=resources_per_replica or {},
            ))
    return wrap(cls) if cls is not None else wrap


class DeploymentRef:
    """Picklable placeholder for a nested deployment in init args; the
    replica resolves it into a live DeploymentHandle at construction
    (reference: deployment-graph composition — passing one bound
    deployment into another's ``.bind()``)."""

    def __init__(self, name: str):
        self.name = name


def _deploy_nested(value, seen: dict):
    """Depth-first deploy of Deployment objects found in init args;
    returns the value with each replaced by a DeploymentRef. ``seen``
    maps deployment name -> the Deployment node already deployed under
    it; two distinct bind nodes sharing a name is an error (they would
    silently alias to one deployment), so composition with the same
    class twice requires ``.options(name=...)``."""
    if isinstance(value, Deployment):
        prior = seen.get(value.name)
        if prior is None:
            seen[value.name] = value
            run(value, _seen=seen)
        elif prior is not value and not (
                prior._cls is value._cls
                and prior._init_args == value._init_args
                and prior._init_kwargs == value._init_kwargs):
            raise ValueError(
                f"two different deployments named {value.name!r} in one "
                "graph; disambiguate with .options(name=...)")
        return DeploymentRef(value.name)
    if isinstance(value, tuple):
        walked = [_deploy_nested(v, seen) for v in value]
        # namedtuples construct positionally, not from an iterable
        return (type(value)(*walked) if hasattr(value, "_fields")
                else tuple(walked))
    if isinstance(value, list):
        return [_deploy_nested(v, seen) for v in value]
    if isinstance(value, dict):
        return {k: _deploy_nested(v, seen) for k, v in value.items()}
    return value


def run(dep: Deployment, *, name: str | None = None,
        _seen: set | None = None) -> DeploymentHandle:
    """Deploy (or redeploy) and return a handle (reference: serve.run:463).

    Composition: any ``Deployment`` nested in the bound init args (incl.
    inside lists/dicts) is deployed first and the replica receives a
    live ``DeploymentHandle`` in its place — the deployment-graph
    pattern (``outer.bind(inner.bind())``)."""
    controller = _get_or_start_controller()
    seen = _seen if _seen is not None else {(name or dep.name): dep}
    dep = Deployment(dep._cls, dep.name, dep.config,
                     _deploy_nested(list(dep._init_args), seen),
                     _deploy_nested(dict(dep._init_kwargs), seen))
    auto = dep.config.autoscaling
    cfg = {
        "num_replicas": dep.config.num_replicas,
        "max_concurrent_queries": dep.config.max_concurrent_queries,
        "autoscaling": vars(auto) if auto else None,
        "user_config": dep.config.user_config,
        "resources_per_replica": dep.config.resources_per_replica,
        # ASGI ingress deployments get raw-request forwarding from the
        # proxies (serve.ingress sets the marker)
        "asgi": bool(getattr(dep._cls, "_serve_asgi", False)),
    }
    dep_name = name or dep.name
    api.get(controller.deploy.remote(
        dep_name, dump_body(dep._cls), dep._init_args, dep._init_kwargs,
        cfg))
    handle = DeploymentHandle(dep_name, controller)
    # wait for at least one replica
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        version, replicas = api.get(
            controller.get_replicas.remote(dep_name))
        if replicas:
            return handle
        time.sleep(0.05)
    raise TimeoutError(f"deployment {dep_name!r} has no replicas after 30s")


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_or_start_controller())


def status() -> dict:
    """Deployment states + replica metrics (reference: serve.status() /
    the REST status schema)."""
    try:
        controller = api.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {"deployments": {}}
    deployments = api.get(controller.list_deployments.remote())
    out = {}
    for name, info in deployments.items():
        _, replicas = api.get(controller.get_replicas.remote(name))
        metrics = []
        for r in replicas or []:
            try:
                metrics.append(api.get(r.metrics.remote(), timeout=2))
            except Exception:  # noqa: BLE001 - replica mid-teardown
                continue
        out[name] = {
            **info,
            "replica_metrics": metrics,
            "total_requests": sum(m.get("total", 0) for m in metrics),
            "ongoing_requests": sum(m.get("ongoing", 0) for m in metrics),
        }
    return {"deployments": out}


def delete(name: str):
    controller = _get_or_start_controller()
    api.get(controller.delete_deployment.remote(name))


def shutdown():
    try:
        controller = api.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        api.get(controller.shutdown.remote(), timeout=10)
    except Exception:  # noqa: BLE001
        pass
    api.kill(controller)


# ---------------------------------------------------------------------------
# dynamic batching (reference: serve/batching.py:65)
# ---------------------------------------------------------------------------

def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: ``fn(self, items: list) -> list`` is invoked with batches
    accumulated across concurrent callers (requires the deployment's
    max_concurrent_queries > 1 so callers overlap)."""

    def wrap(fn):
        # batching state lives on the replica INSTANCE, created lazily.
        # The wrapper is a
        # COROUTINE: replicas are asyncio actors, so concurrent callers
        # are coroutines on one loop — accumulation is cooperative
        # (futures + a timed shield), no threads or locks.
        attr = f"__serve_batch_state_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, item):
            import asyncio
            import inspect

            state = self.__dict__.setdefault(attr, {"queue": []})
            entry = {"item": item,
                     "fut": asyncio.get_running_loop().create_future()}
            state["queue"].append(entry)
            if len(state["queue"]) < max_batch_size:
                # linger for batchmates; shield() keeps a timeout from
                # cancelling a future another flusher may yet complete
                try:
                    await asyncio.wait_for(asyncio.shield(entry["fut"]),
                                           timeout=batch_wait_timeout_s)
                except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                    pass
            # Flush until OUR entry completes: a caller may flush batches
            # that don't contain its own entry (they were queued first);
            # it then loops and flushes the next batch rather than
            # stranding itself.
            while not entry["fut"].done():
                batch_entries = state["queue"][:max_batch_size]
                state["queue"] = state["queue"][max_batch_size:]
                if not batch_entries:
                    await asyncio.sleep(0.005)
                    continue
                try:
                    if inspect.iscoroutinefunction(fn):
                        results = await fn(
                            self, [e["item"] for e in batch_entries])
                    else:
                        # sync batch fn (the common case: a blocking
                        # model call) runs OFF the loop — freezing the
                        # replica's loop for a whole batch would stall
                        # accumulation of the next batch and every other
                        # call on the replica
                        import functools as _ft

                        results = await asyncio.get_running_loop() \
                            .run_in_executor(None, _ft.partial(
                                fn, self,
                                [e["item"] for e in batch_entries]))
                        if inspect.isawaitable(results):
                            results = await results
                    for e, r in zip(batch_entries, results):
                        if not e["fut"].done():
                            e["fut"].set_result(r)
                except BaseException as err:  # noqa: BLE001
                    for e in batch_entries:
                        if not e["fut"].done():
                            e["fut"].set_exception(err)
            return await entry["fut"]   # done: value or raise

        wrapper.__wrapped_batch__ = fn
        return wrapper

    return wrap if _fn is None else wrap(_fn)


# ---------------------------------------------------------------------------
# HTTP proxy (reference: _private/proxy.py — uvicorn HTTP; stdlib here)
# ---------------------------------------------------------------------------

class _ProxyHandler(BaseHTTPRequestHandler):
    # handle cache is per proxy server: start_http_proxy subclasses this
    # with a fresh dict (a class-level cache would leak stale controller
    # references across serve.shutdown()/restart cycles)
    handles: dict[str, DeploymentHandle]
    asgi_flags: dict[str, bool]

    def log_message(self, *args):  # silence request logging
        pass

    def _resolve(self, name: str):
        handle = self.handles.get(name)
        if handle is None:
            handle = get_deployment_handle(name)
            handle._refresh(ttl=0)  # raises KeyError if unknown
            self.handles[name] = handle
        asgi = self.asgi_flags.get(name)
        if asgi is None:
            meta = api.get(
                handle._controller.deployment_meta.remote(name))
            asgi = bool(meta.get("asgi"))
            self.asgi_flags[name] = asgi
        return handle, asgi

    def _reply(self, code: int, body: bytes,
               content_type: str = "application/json", headers=()):
        self.send_response(code)
        sent_ct = False
        for k, v in headers:
            if k.lower() == "content-length":
                continue  # we recompute it
            if k.lower() == "content-type":
                sent_ct = True
            self.send_header(k, v)
        if not sent_ct:
            self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self):
        if self.path in ("/-/healthz", "/healthz"):
            self._reply(200, b"ok", "text/plain")
            return
        from urllib.parse import urlsplit

        split = urlsplit(self.path)
        parts = split.path.strip("/").split("/", 1)
        name = parts[0]
        subpath = "/" + (parts[1] if len(parts) > 1 else "")
        try:
            handle, asgi = self._resolve(name)
        except Exception:  # noqa: BLE001
            self.send_error(404, f"no deployment {name!r}")
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        try:
            if asgi:
                # raw-request forwarding: the replica's mounted ASGI app
                # owns routing/methods/content types
                out = handle.call({
                    "__raw__": True, "method": self.command,
                    "path": subpath, "query_string": split.query,
                    "headers": list(self.headers.items()), "body": body,
                })
                self._reply(out.get("status", 500),
                            out.get("body", b""),
                            headers=out.get("headers", ()))
                return
            payload = json.loads(body) if body else {}
            result = handle.call(payload)
            self._reply(200, json.dumps({"result": result}).encode())
        except Exception as e:  # noqa: BLE001
            self._reply(500, json.dumps({"error": repr(e)}).encode())

    def do_POST(self):
        self._route()

    def do_GET(self):
        self._route()

    def do_PUT(self):
        self._route()

    def do_DELETE(self):
        self._route()

    def do_PATCH(self):
        self._route()


def start_http_proxy(host: str = "127.0.0.1", port: int = 0):
    """Start the HTTP ingress; returns (server, (host, port)). POST
    /<deployment> with a JSON body routes to the deployment's __call__."""
    handler = type("_ProxyHandlerInstance", (_ProxyHandler,),
                   {"handles": {}, "asgi_flags": {}})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address
