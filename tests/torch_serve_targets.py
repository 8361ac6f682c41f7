"""Import targets of the port's Serve ingress, config and CLI tests.

The counterparts of ``tests/_serve_config_target.py`` and of the ASGI
apps of ``tests/test_serve_ingress.py``, for ``ray_tpu_torch``: the port
carries a deployment body by stdlib pickle, by reference, so its bodies
live at module level, and this module imports nothing of ``ray_tpu``
(a cluster's worker imports it).
"""

import asyncio
import json
from collections import namedtuple

from ray_tpu_torch import serve


@serve.deployment
class Greeter:
    def __init__(self, greeting: str = "hello"):
        self.greeting = greeting

    def __call__(self, name: str) -> str:
        return f"{self.greeting} {name}"


greeter = Greeter  # plain Deployment (unbound)
bound_greeter = Greeter.bind("hi")

Point = namedtuple("Point", "x y")


def make_echo_app():
    """A bare ASGI app (no framework) with its own state: routes on path
    and method, echoes the request, and answers ``/state`` from what its
    lifespan startup set. ``serve.ingress`` calls this zero-argument
    factory in the replica."""
    state: dict = {}

    async def echo_app(scope, receive, send):
        if scope["type"] == "lifespan":
            msg = await receive()
            if msg["type"] == "lifespan.startup":
                state["started"] = True
                await send({"type": "lifespan.startup.complete"})
            return
        msg = await receive()
        body = msg.get("body", b"")
        headers = [(b"content-type", b"application/json"),
                   (b"x-echo-method", scope["method"].encode())]
        if scope["path"] == "/status":
            payload, code = b'{"status": "healthy"}', 200
        elif scope["path"] == "/state":
            payload, code = json.dumps(state).encode(), 200
        elif scope["path"] == "/slow":
            await asyncio.sleep(float(scope["query_string"].decode() or 5))
            payload, code = b"late", 200
        elif scope["method"] == "PUT":
            payload, code = b"put:" + body, 201
            headers = [(b"content-type", b"text/plain")]
        else:
            payload, code = json.dumps({
                "method": scope["method"], "path": scope["path"],
                "query": scope["query_string"].decode(),
                "echo": body.decode() if body else "",
            }).encode(), 200
        await send({"type": "http.response.start", "status": code,
                    "headers": headers})
        await send({"type": "http.response.body", "body": payload})

    return echo_app


@serve.deployment(name="asgiapp")
@serve.ingress(make_echo_app)
class AsgiApp:
    pass


@serve.deployment(name="plainj")
class Plain:
    def __call__(self, payload):
        return {"doubled": payload.get("x", 0) * 2}


@serve.deployment(name="grpcd")
class Adder:
    def __call__(self, payload):
        return {"sum": payload["a"] + payload["b"]}
