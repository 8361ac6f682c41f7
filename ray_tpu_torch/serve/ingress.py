"""ASGI mounting + gRPC ingress for Serve.

Port of ``ray_tpu/serve/ingress.py``, with its ingress-latency histogram
(``ray_tpu_serve_ingress_s``) and without the driver's synchronous
``handle``, which nothing calls. ``grpc`` is imported inside the gRPC
functions, as in JAX; where it is not installed they raise
``ImportError``.

Reference analogs: deployments mounting FastAPI apps
(``@serve.ingress(app)``, ``python/ray/serve/api.py``) and the gRPC
proxy path (``serve/_private/proxy.py:375`` + ``grpc_util.py``).

- :func:`ingress` — wrap ANY ASGI application (FastAPI, Starlette, or a
  bare ``async def app(scope, receive, send)``) so a deployment serves
  it: the replica drives the ASGI protocol directly on a private event
  loop (no uvicorn needed), and the HTTP proxy forwards the raw request
  (method/path/headers/body) instead of the fixed JSON shape.
- :func:`start_grpc_proxy` — a generic gRPC ingress: unary call to
  ``/ray_tpu.serve.Serve/<deployment>`` with a JSON-bytes payload routes
  to that deployment, mirroring the HTTP proxy's routing. Generic
  handlers keep it proto-stub-free (clients use
  ``channel.unary_unary("/ray_tpu.serve.Serve/<name>")``).
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

from ray_tpu_torch.util import metrics as _metrics

# per-request ingress timer (metrics plane): full replica-side handling
# latency of one proxied HTTP request through the ASGI app
_h_ingress = _metrics.histogram(
    "ray_tpu_serve_ingress_s",
    "replica-side ASGI ingress request handling latency").handle()


class _ASGIDriver:
    """Drives one ASGI app on a dedicated event loop thread and turns
    raw-request dicts into raw-response dicts."""

    def __init__(self, app):
        self.app = app
        self._loop = asyncio.new_event_loop()
        t = threading.Thread(target=self._loop.run_forever, daemon=True,
                             name="serve-asgi-loop")
        t.start()
        # ASGI lifespan: best-effort startup (apps that don't implement
        # it raise/ignore — both fine)
        try:
            asyncio.run_coroutine_threadsafe(
                self._lifespan("startup"), self._loop).result(timeout=10)
        except Exception:  # noqa: BLE001
            pass

    async def _lifespan(self, phase: str):
        sent = []

        async def receive():
            return {"type": f"lifespan.{phase}"}

        async def send(msg):
            sent.append(msg)

        try:
            await self.app({"type": "lifespan", "asgi": {"version": "3.0"}},
                           receive, send)
        except Exception:  # noqa: BLE001 - app has no lifespan support
            pass

    async def _run(self, request: dict) -> dict:
        body = request.get("body", b"")
        sent_body = False
        status = {"code": 500, "headers": []}
        chunks: list[bytes] = []
        done = asyncio.Event()

        async def receive():
            nonlocal sent_body
            if not sent_body:
                sent_body = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            await done.wait()           # no more input
            return {"type": "http.disconnect"}

        async def send(msg):
            if msg["type"] == "http.response.start":
                status["code"] = msg["status"]
                status["headers"] = [
                    (k.decode() if isinstance(k, bytes) else k,
                     v.decode() if isinstance(v, bytes) else v)
                    for k, v in msg.get("headers", [])]
            elif msg["type"] == "http.response.body":
                chunks.append(msg.get("body", b""))
                if not msg.get("more_body"):
                    done.set()

        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.get("method", "GET"),
            "scheme": "http",
            "path": request.get("path", "/"),
            "raw_path": request.get("path", "/").encode(),
            "root_path": "",
            "query_string": request.get("query_string", b"")
            if isinstance(request.get("query_string", b""), bytes)
            else request.get("query_string", "").encode(),
            "headers": [(k.lower().encode(), v.encode())
                        for k, v in request.get("headers", [])],
            "client": ("127.0.0.1", 0),
            "server": ("127.0.0.1", 80),
        }
        await self.app(scope, receive, send)
        done.set()
        return {"__raw__": True, "status": status["code"],
                "headers": status["headers"], "body": b"".join(chunks)}

    async def ahandle(self, request: dict) -> dict:
        """Await the app (on its dedicated loop) from ANOTHER loop,
        with the same per-request timeout the sync path enforces — a
        hung app must surface an error, not hold a concurrency slot
        forever."""
        t0 = time.perf_counter()
        fut = asyncio.run_coroutine_threadsafe(self._run(request),
                                               self._loop)
        try:
            out = await asyncio.wait_for(
                asyncio.wrap_future(fut),
                timeout=request.get("timeout_s", 60))
            if _metrics.enabled():
                _h_ingress.observe(time.perf_counter() - t0)
            return out
        except asyncio.TimeoutError:
            fut.cancel()
            raise TimeoutError(
                f"ASGI app did not answer within "
                f"{request.get('timeout_s', 60)}s") from None


def ingress(asgi_app_or_factory):
    """Class decorator: the deployment serves the given ASGI app.

    ``@serve.deployment`` + ``@serve.ingress(app)`` compose like the
    reference; the wrapped class's methods remain available for handle
    calls, while HTTP traffic hitting the proxy under
    ``/<deployment>/...`` is forwarded verbatim through the ASGI app.
    Pass either an app instance or a zero-arg factory (a factory defers
    construction to the replica — needed when the app isn't picklable).
    """

    def wrap(cls):
        class ASGIIngress(cls):
            _serve_asgi = True

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                app = asgi_app_or_factory
                target = app() if (callable(app)
                                   and not _looks_like_asgi(app)) else app
                self._asgi_driver = _ASGIDriver(target)

            async def __call__(self, request: dict):
                # async: the replica's event loop awaits the app's own
                # loop WITHOUT blocking, so concurrent HTTP requests
                # overlap per replica (the app keeps its dedicated loop —
                # lifespan-created state stays loop-consistent)
                if isinstance(request, dict) and request.get("__raw__"):
                    return await self._asgi_driver.ahandle(request)
                # non-raw payloads (handle.call) become a POST /
                body = json.dumps(request).encode() \
                    if not isinstance(request, (bytes, bytearray)) \
                    else bytes(request)
                return await self._asgi_driver.ahandle({
                    "__raw__": True, "method": "POST", "path": "/",
                    "headers": [("content-type", "application/json")],
                    "body": body})

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = cls.__qualname__
        # the port carries a deployment body by stdlib pickle, by the name
        # its module bound it under: the wrapped class takes the module of
        # the class it wraps, where ``@serve.deployment`` binds it
        ASGIIngress.__module__ = cls.__module__
        return ASGIIngress

    return wrap


def _looks_like_asgi(app) -> bool:
    """An ASGI app is an async callable taking (scope, receive, send) —
    distinguish it from a zero-arg factory."""
    import inspect

    fn = app if inspect.isfunction(app) or inspect.iscoroutinefunction(app) \
        else getattr(app, "__call__", None)
    if fn is None:
        return False
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return len(params) >= 3


# ---------------------------------------------------------------------------
# gRPC ingress
# ---------------------------------------------------------------------------

GRPC_SERVICE = "ray_tpu.serve.Serve"


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0):
    """Start the gRPC ingress; returns (server, port).

    Routing mirrors the HTTP proxy: a unary call to
    ``/ray_tpu.serve.Serve/<deployment>`` carries a JSON request as
    bytes and returns ``{"result": ...}`` JSON bytes (errors surface as
    INTERNAL/NOT_FOUND status codes). Generic handlers = no proto stubs
    to generate, any grpc client can call it.
    """
    import grpc

    from ray_tpu_torch.serve.api import get_deployment_handle

    handles: dict = {}

    class _Router(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            method = handler_call_details.method  # /pkg.Service/Name
            parts = method.strip("/").split("/")
            if len(parts) != 2 or parts[0] != GRPC_SERVICE:
                return None
            name = parts[1]

            def unary(request_bytes, context):
                handle = handles.get(name)
                if handle is None:
                    try:
                        handle = get_deployment_handle(name)
                        handle._refresh(ttl=0)
                        handles[name] = handle
                    except Exception:  # noqa: BLE001
                        context.abort(grpc.StatusCode.NOT_FOUND,
                                      f"no deployment {name!r}")
                try:
                    payload = (json.loads(request_bytes)
                               if request_bytes else {})
                    result = handle.call(payload)
                    return json.dumps({"result": result}).encode()
                except Exception as e:  # noqa: BLE001
                    context.abort(grpc.StatusCode.INTERNAL, repr(e))

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b)

    from concurrent import futures

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
    server.add_generic_rpc_handlers((_Router(),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


def grpc_call(port: int, deployment: str, payload: dict,
              host: str = "127.0.0.1", timeout: float = 30.0):
    """Convenience client for the generic gRPC ingress."""
    import grpc

    with grpc.insecure_channel(f"{host}:{port}") as channel:
        rpc = channel.unary_unary(
            f"/{GRPC_SERVICE}/{deployment}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        out = rpc(json.dumps(payload).encode(), timeout=timeout)
    return json.loads(out)
