"""The port's Serve ingress and declarative config against the JAX package's.

Both in-process runtimes start once for the module. The same bare ASGI
app (``torch_serve_targets.make_echo_app``, no framework) is mounted with
``serve.ingress`` in each package, and the same raw requests through each
package's HTTP proxy must give equal status, headers (but the ``Date``
each server stamps) and body: routing on path and method, the query
string, the lifespan startup's state, a handle call that becomes a POST,
a plain deployment's JSON contract, and a hung app's timeout. The gRPC
ingress runs where ``grpc`` is installed. Then ``serve/schema.py``: each
bad config raises the same ``ValueError`` text in both packages (the
module of the import path substituted), the init-args layering builds
the same deployments, and a config dict and a JSON file deploy and answer
alike; a file that is not JSON needs ``yaml``.
"""

import importlib
import json
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.serve import schema as jschema
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import schema as tschema

import torch_serve_targets as targets

JAX_TARGET = "tests._serve_config_target"
TORCH_TARGET = "torch_serve_targets"


@pytest.fixture(scope="module")
def runtimes():
    """Both in-process runtimes, each with its HTTP proxy."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    proxies = {"jax": jserve.start_http_proxy(),
               "torch": tserve.start_http_proxy()}
    yield {"jax": (jserve, proxies["jax"][1]),
           "torch": (tserve, proxies["torch"][1])}
    for server, _ in proxies.values():
        server.shutdown()
    jserve.shutdown()
    tserve.shutdown()
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _jax_asgi_app():
    cls = type("AsgiApp", (), {})
    return jserve.deployment(name="asgiapp")(
        jserve.ingress(targets.make_echo_app)(cls))


def _http(addr, method, path, body=None):
    host, port = addr
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, headers, out = resp.status, resp.getheaders(), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, out = e.code, e.headers.items(), e.read()
    return status, sorted((k, v) for k, v in headers if k != "Date"), out


REQUESTS = [
    ("GET", "/asgiapp/status", None),
    ("POST", "/asgiapp/predict?k=v&n=2", b"data"),
    ("PUT", "/asgiapp/thing", b"xyz"),
    ("DELETE", "/asgiapp/", None),
    ("GET", "/asgiapp/state", None),
]


def test_asgi_ingress_raw_requests_match(runtimes):
    handles = {"jax": jserve.run(_jax_asgi_app().bind()),
               "torch": tserve.run(targets.AsgiApp.bind())}
    got = {name: [_http(addr, m, p, b) for m, p, b in REQUESTS]
           for name, (_, addr) in runtimes.items()}
    assert got["jax"] == got["torch"]
    assert got["torch"][0][2] == b'{"status": "healthy"}'
    status, headers, body = got["torch"][1]
    assert status == 200 and ("x-echo-method", "POST") in headers
    assert json.loads(body) == {"method": "POST", "path": "/predict",
                                "query": "k=v&n=2", "echo": "data"}
    assert got["torch"][2][0] == 201 and got["torch"][2][2] == b"put:xyz"
    # the lifespan startup ran once in the replica before any request
    assert json.loads(got["torch"][4][2]) == {"started": True}
    # the handle path: a non-raw payload becomes POST / with JSON
    calls = {name: h.call({"k": 1}) for name, h in handles.items()}
    assert calls["jax"] == calls["torch"]
    assert calls["torch"]["status"] == 200
    assert json.loads(json.loads(calls["torch"]["body"])["echo"]) == {"k": 1}
    # a hung app surfaces a timeout, not a held slot
    raw = {"__raw__": True, "method": "GET", "path": "/slow",
           "query_string": "5", "headers": [], "body": b"",
           "timeout_s": 0.3}
    errors = {}
    for name, h in handles.items():
        with pytest.raises(Exception) as ei:
            h.call(raw)
        errors[name] = ("did not answer within 0.3s" in str(ei.value))
    assert errors == {"jax": True, "torch": True}


def test_plain_deployment_keeps_json_contract_and_404(runtimes):
    jplain = jserve.deployment(name="plainj")(
        type("Plain", (), {"__call__": targets.Plain._cls.__call__}))
    jserve.run(jplain.bind())
    tserve.run(targets.Plain.bind())
    got = {name: [_http(addr, "POST", "/plainj",
                        json.dumps({"x": 21}).encode()),
                  _http(addr, "GET", "/nope")[0]]
           for name, (_, addr) in runtimes.items()}
    assert got["jax"] == got["torch"]
    assert json.loads(got["torch"][0][2]) == {"result": {"doubled": 42}}
    assert got["torch"][1] == 404


def test_grpc_ingress(runtimes):
    grpc = pytest.importorskip("grpc")
    # the modules (each package's ``serve.ingress`` name is the function)
    jingress = importlib.import_module("ray_tpu.serve.ingress")
    tingress = importlib.import_module("ray_tpu_torch.serve.ingress")

    assert tingress.GRPC_SERVICE == jingress.GRPC_SERVICE
    jadd = jserve.deployment(name="grpcd")(
        type("Adder", (), {"__call__": targets.Adder._cls.__call__}))
    jserve.run(jadd.bind())
    tserve.run(targets.Adder.bind())
    out = {}
    for name, serve, call in (("jax", jserve, jingress.grpc_call),
                              ("torch", tserve, tingress.grpc_call)):
        server, port = serve.start_grpc_proxy()
        try:
            ok = call(port, "grpcd", {"a": 2, "b": 40})
            with pytest.raises(grpc.RpcError) as err:
                call(port, "nope", {})
            out[name] = (ok, err.value.code())
        finally:
            server.stop(0)
    assert out["jax"] == out["torch"]
    assert out["torch"] == ({"result": {"sum": 42}},
                            grpc.StatusCode.NOT_FOUND)


# --- serve/schema.py ---


def _error(fn, target):
    try:
        fn()
    except ValueError as e:
        return str(e).replace(target, "<target>")
    return None


BAD_CONFIGS = [
    "not a mapping",
    {"deploymets": []},
    {},
    {"deployments": [{"name": "X"}]},
    {"deployments": ["entry"]},
    {"deployments": [{"import_path": "<target>:greeter", "replicas": 2}]},
    {"deployments": [{"import_path": "<target>:Point"}]},
    {"deployments": [{"import_path": "<target>:greeter"},
                     {"import_path": "<target>:nope"}]},
    {"deployments": [{"import_path": "nocolon"}]},
    {"applications": [{"name": "a"}]},
    {"applications": [
        {"name": "a1", "deployments": [{"import_path": "<target>:greeter"}]},
        {"name": "a2", "deployments": [{"import_path": "<target>:greeter"}]},
    ]},
    {"deployments": [{"import_path": "<target>:greeter",
                      "autoscaling_config": {"bogus": 1}}]},
]


def _with_target(cfg, target):
    return json.loads(json.dumps(cfg).replace("<target>", target))


def test_schema_errors_match(runtimes):
    for cfg in BAD_CONFIGS:
        want = _error(lambda: jschema.apply_config(
            _with_target(cfg, JAX_TARGET)), JAX_TARGET)
        got = _error(lambda: tschema.apply_config(
            _with_target(cfg, TORCH_TARGET)), TORCH_TARGET)
        assert want is not None and got == want, cfg
    # a config error leaves nothing deployed
    assert "Greeter" not in tserve.status()["deployments"]


LAYERED = [
    {"import_path": "<target>:greeter"},
    {"import_path": "<target>:bound_greeter"},
    {"import_path": "<target>:bound_greeter", "init_kwargs": {}},
    {"import_path": "<target>:bound_greeter", "init_args": ["yo"]},
    {"import_path": "<target>:greeter", "name": "G2", "num_replicas": 3,
     "init_kwargs": {"greeting": "hey"}, "user_config": {"t": 0.2},
     "max_concurrent_queries": 4,
     "autoscaling_config": {"min_replicas": 1, "max_replicas": 4}},
]


def _built(schema, spec, target):
    dep = schema._build_one(_with_target(spec, target), "d")
    cfg = dep.config
    return (dep.name, list(dep._init_args), dict(dep._init_kwargs),
            cfg.num_replicas, cfg.max_concurrent_queries, cfg.user_config,
            vars(cfg.autoscaling) if cfg.autoscaling else None,
            cfg.resources_per_replica)


def test_schema_layering_builds_the_same_deployments():
    for spec in LAYERED:
        assert (_built(tschema, spec, TORCH_TARGET)
                == _built(jschema, spec, JAX_TARGET)), spec
    gpu = _built(tschema, {"import_path": "<target>:greeter",
                           "resources_per_replica": {"GPU": 1}},
                 TORCH_TARGET)
    assert gpu[-1] == {"GPU": 1}


def test_apply_config_dict_and_json_file_match(runtimes, tmp_path):
    out = {}
    for name, schema, target in (("jax", jschema, JAX_TARGET),
                                 ("torch", tschema, TORCH_TARGET)):
        handles = schema.apply_config({"applications": [{
            "name": "app", "deployments": [{
                "name": "G2", "import_path": f"{target}:greeter",
                "init_args": ["yo"], "num_replicas": 2}]}]})
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"deployments": [
            {"import_path": f"{target}:bound_greeter", "user_config": {}}]}))
        from_file = schema.apply_config_file(str(path))
        out[name] = (sorted(handles), handles["G2"].call("x"),
                     sorted(from_file), from_file["Greeter"].call("there"))
    assert out["jax"] == out["torch"]
    assert out["torch"] == (["G2"], "yo x", ["Greeter"], "hi there")


def test_apply_config_file_reads_yaml_only_with_yaml(runtimes, tmp_path,
                                                     monkeypatch):
    path = tmp_path / "serve.yaml"
    path.write_text("deployments:\n"
                    f"  - import_path: {TORCH_TARGET}:greeter\n"
                    "    name: G3\n"
                    "    init_args: [hey]\n")
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    with pytest.raises(ImportError, match="yaml.*JSON"):
        tschema.apply_config_file(str(path))
    monkeypatch.undo()
    pytest.importorskip("yaml")
    handles = tschema.apply_config_file(str(path))
    assert handles["G3"].call("u") == "hey u"
