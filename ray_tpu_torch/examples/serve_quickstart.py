"""Quickstart: serve a model graph over HTTP.

    python -m ray_tpu_torch.examples.serve_quickstart

Port of ``ray_tpu/examples/serve_quickstart.py`` (reference analog: the
serve.run / deployment-graph quickstarts in the reference's Serve docs),
on the port's in-process runtime. The graph runs on the host; no card is
needed.
"""

import json
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment
class Preprocess:
    def __call__(self, payload):
        return [float(x) for x in payload["values"]]


@serve.deployment(num_replicas=2)
class Model:
    def __init__(self, scale):
        self.scale = scale

    def __call__(self, values):
        return {"sum": sum(values) * self.scale}


@serve.deployment
class Pipeline:
    def __init__(self, pre, model):
        self.pre, self.model = pre, model

    def __call__(self, payload):
        values = ray_tpu_torch.get(self.pre.remote(payload))
        return ray_tpu_torch.get(self.model.remote(values))


def main() -> dict:
    """Deploy the graph, call it directly and over HTTP, and shut down;
    returns both answers (``"direct"``, ``"http"``)."""
    ray_tpu_torch.init(num_cpus=4)
    try:
        handle = serve.run(Pipeline.bind(Preprocess.bind(), Model.bind(2.0)))
        direct = handle.call({"values": [1, 2, 3]})
        print("direct call:", direct)

        server, (host, port) = serve.start_http_proxy()
        try:
            req = urllib.request.Request(
                f"http://{host}:{port}/Pipeline",
                data=json.dumps({"values": [4, 5]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                http = json.load(resp)
            print("HTTP call:", http)
        finally:
            server.shutdown()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    return {"direct": direct, "http": http}


if __name__ == "__main__":
    main()
