"""The port's Serve plane on its in-process runtime against the JAX package's.

Each scenario of tests/test_serve.py and tests/test_serve_scaleout.py that
needs no ingress, YAML schema, CLI or metrics plane runs once on
``ray_tpu.serve`` and once on ``ray_tpu_torch.serve`` and must give the
same result. Then prefix-affinity routing: ``PrefixRouter``'s picks and
``digest_hashes`` across the packages, the paged engine's published digest
for the same prompt, ``LLMDeployment`` under ``serve.run`` on the CPU
against JAX's, and two ``llama_tiny`` replicas where the holder of a
prefix takes every request that carries it.

Deployment bodies live at module level: the port carries them to its
replicas by stdlib pickle (the JAX package by cloudpickle). A body that
uses a package's decorator (``batch``, ``multiplexed``) has a class per
package.
"""

import collections
import dataclasses
import json
import time
import urllib.request

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import llama as jllama
from ray_tpu.runtime import core as jcore
from ray_tpu.runtime import metrics_plane
from ray_tpu.serve import prefix_router as jrouter
from ray_tpu.serve.llm import LLMDeployment as JaxLLMDeployment
from ray_tpu.serve.paged_llm import PagedLLMEngine as JaxPagedLLMEngine
from ray_tpu_torch import convert
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.runtime import annex
from ray_tpu_torch.runtime import core as tcore
from ray_tpu_torch.serve import prefix_router as trouter
from ray_tpu_torch.serve.llm import LLMDeployment
from ray_tpu_torch.serve.paged_llm import PagedLLMEngine
from ray_tpu_torch.util import state as tstate

PACKAGES = {"jax": (ray_tpu, jserve), "torch": (ray_tpu_torch, tserve)}


@pytest.fixture(scope="module")
def runtimes():
    """Both in-process runtimes, started once for the module."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield PACKAGES
    jserve.shutdown()
    tserve.shutdown()
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture
def both(runtimes):
    yield runtimes
    for _, serve in runtimes.values():
        serve.shutdown()


@pytest.fixture(autouse=True)
def _clear_annexes():
    def clear():
        for key in list(metrics_plane.local_annexes()):
            metrics_plane.set_annex(key, None)
        for key in list(annex.local_annexes()):
            annex.set_annex(key, None)
    clear()
    yield
    clear()


def _error_name(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "no error"


def _wait_running(serve, name, want, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if serve.status()["deployments"].get(name, {}).get(
                "running", 0) >= want:
            return True
        time.sleep(0.05)
    return False


# --- deployment bodies ---


class Echo:
    def __call__(self, x):
        return {"echo": x}


class Adder:
    def __init__(self, base):
        self.base = base

    def __call__(self, x):
        return self.base + x

    def double(self, x):
        return 2 * x


class WhoAmI:
    def __call__(self, _):
        return id(self)


class V1:
    def __call__(self, _):
        return "v1"


class V2:
    def __call__(self, _):
        return "v2"


class Conf:
    def __init__(self):
        self.threshold = 0

    def reconfigure(self, cfg):
        self.threshold = cfg["threshold"]

    def __call__(self, _):
        return self.threshold


class Slow:
    def __call__(self, delay):
        time.sleep(delay)
        return "ok"


class Api:
    def __call__(self, payload):
        return {"sum": payload["a"] + payload["b"]}


class Streamer:
    def generate(self, n):
        for i in range(n):
            yield i * i


class Bad:
    def generate(self):
        yield 1
        raise ValueError("stream-boom")


class Partial:
    def generate(self):
        yield "a"
        yield "b"
        raise RuntimeError("later-boom")


class Preprocess:
    def __call__(self, x):
        return x * 2


class Model:
    def __init__(self, prefix):
        self.prefix = prefix

    def __call__(self, x):
        return f"{self.prefix}:{x}"


class Pipeline:
    def __init__(self, pre, model):
        self.pre = pre
        self.model = model

    def __call__(self, x):
        y = self.pre.call(x)
        return self.model.call(y)


class Leaf:
    def __init__(self, k):
        self.k = k

    def __call__(self):
        return self.k


class Fanout:
    def __init__(self, legs):
        self.legs = legs

    def __call__(self):
        legs = (self.legs.values() if isinstance(self.legs, dict)
                else self.legs)
        return sorted(h.call() for h in legs)


Point = collections.namedtuple("Point", ["x", "y"])


class Holder:
    def __init__(self, p, coords):
        self.p = p
        self.coords = coords

    def __call__(self):
        return (type(self.p).__name__, self.p.x + self.p.y, self.coords)


def _batched(serve, name):
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def __call__(self, x):
            return self.handle(x)

        def sizes(self):
            return self.batch_sizes

    Batched.__name__ = Batched.__qualname__ = name
    return Batched


def _mux(serve, name):
    class Mux:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return {"id": model_id, "scale": int(model_id[-1])}

        def __call__(self, payload):
            return self.get_model()["scale"] * payload["x"]

        def generate(self, n):
            m = self.get_model()["id"]
            for i in range(n):
                yield f"{m}-{i}"

    Mux.__name__ = Mux.__qualname__ = name
    return Mux


BatchedJax, BatchedTorch = _batched(jserve, "BatchedJax"), \
    _batched(tserve, "BatchedTorch")
MuxJax, MuxTorch = _mux(jserve, "MuxJax"), _mux(tserve, "MuxTorch")


def _per_package(serve, jax_cls, torch_cls):
    return jax_cls if serve is jserve else torch_cls


# --- scenarios: each returns what both packages must agree on ---


def deploy_and_call(pkg, serve):
    handle = serve.run(serve.deployment(Echo).bind())
    adder = serve.run(serve.deployment(Adder).bind(100))
    return [handle.call("hi"), adder.call(5),
            adder.options(method_name="double").call(21)]


def multiple_replicas_route(pkg, serve):
    handle = serve.run(serve.deployment(num_replicas=3)(WhoAmI).bind())
    up = _wait_running(serve, "WhoAmI", 2)
    return up and len({handle.call(None) for _ in range(30)}) >= 2


def redeploy_updates(pkg, serve):
    serve.run(serve.deployment(V1).options(name="V").bind())
    handle = serve.run(serve.deployment(name="V")(V2).bind())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if handle.call(None) == "v2":
            return "v2"
        time.sleep(0.1)
    return "v1"


def user_config_reconfigure(pkg, serve):
    handle = serve.run(serve.deployment(user_config={"threshold": 7})(
        Conf).bind())
    return handle.call(None)


def dynamic_batching(pkg, serve):
    cls = _per_package(serve, BatchedJax, BatchedTorch)
    handle = serve.run(serve.deployment(max_concurrent_queries=16)(
        cls).bind())
    out = sorted(pkg.get([handle.remote(i) for i in range(16)]))
    sizes = handle.options(method_name="sizes").call()
    return out, max(sizes) > 1


def autoscaling_up_polled(pkg, serve):
    handle = serve.run(serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3, "policy": "polled",
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.1,
        "downscale_delay_s": 60.0}, max_concurrent_queries=4)(Slow).bind())
    refs = [handle.remote(0.4) for _ in range(12)]
    scaled = _wait_running(serve, "Slow", 2, timeout=15)
    mode = serve.status()["deployments"]["Slow"]["autoscale_mode"]
    return scaled, mode, pkg.get(refs)


def http_proxy(pkg, serve):
    serve.run(serve.deployment(Api).bind())
    server, (host, port) = serve.start_http_proxy()
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/Api",
            data=json.dumps({"a": 2, "b": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        health = urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=10).status
        try:
            urllib.request.urlopen(f"http://{host}:{port}/Nope", timeout=10)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
    finally:
        server.shutdown()
    return body, health, missing


def delete_deployment(pkg, serve):
    handle = serve.run(serve.deployment(Echo).options(name="Gone").bind())
    first = handle.call(1)
    serve.delete("Gone")
    time.sleep(0.3)
    return first, _error_name(
        lambda: serve.get_deployment_handle("Gone").call(None))


def multiplexed_models(pkg, serve):
    cls = _per_package(serve, MuxJax, MuxTorch)
    handle = serve.run(serve.deployment(cls).bind(), name="mux")
    h1 = handle.options(multiplexed_model_id="m1")
    h2 = handle.options(multiplexed_model_id="m2")
    out = [h1.call({"x": 10}), h2.call({"x": 10}), h1.call({"x": 5})]
    handle._refresh(ttl=0)
    ids = sorted(pkg.get(handle._replicas[0].multiplexed_model_ids.remote()))
    out.append(handle.options(multiplexed_model_id="m3").call({"x": 1}))
    after = sorted(pkg.get(
        handle._replicas[0].multiplexed_model_ids.remote()))
    streamed = list(handle.options(method_name="generate",
                                   multiplexed_model_id="m7").stream(2))
    return out, ids, after, streamed


def streaming(pkg, serve):
    handle = serve.run(serve.deployment(Streamer).bind(), name="streamer")
    chunks = list(handle.options(method_name="generate").stream(30))
    bad = serve.run(serve.deployment(Bad).bind(), name="bad_stream")
    try:
        list(bad.options(method_name="generate").stream())
        bad_err = "no error"
    except Exception as e:  # noqa: BLE001
        bad_err = "stream-boom" in str(e)
    part = serve.run(serve.deployment(Partial).bind(), name="partial")
    got = []
    try:
        for c in part.options(method_name="generate").stream():
            got.append(c)
        part_err = "no error"
    except Exception as e:  # noqa: BLE001
        part_err = "later-boom" in str(e)
    return chunks, bad_err, got, part_err


def serve_status(pkg, serve):
    handle = serve.run(serve.deployment(num_replicas=2)(Echo).bind(),
                       name="stat")
    for _ in range(4):
        handle.call({})
    st = serve.status()["deployments"]["stat"]
    return st["total_requests"] >= 4, st["target"], st["config"][
        "num_replicas"]


def graph_composition(pkg, serve):
    handle = serve.run(serve.deployment(Pipeline).bind(
        serve.deployment(Preprocess).bind(),
        serve.deployment(Model).bind("out")))
    out = [handle.call(21), sorted(serve.status()["deployments"]),
           serve.get_deployment_handle("Preprocess").call(5)]
    fan = serve.run(serve.deployment(Fanout).bind(
        {"a": serve.deployment(Leaf).options(name="LeafA").bind(1),
         "b": serve.deployment(Leaf).options(name="LeafB").bind(2)}))
    out.append(fan.call())
    leaf = serve.deployment(Leaf)
    out.append(_error_name(lambda: serve.run(serve.deployment(Fanout).options(
        name="Clash").bind([leaf.bind(1), leaf.bind(2)]))))
    shared = leaf.options(name="Shared").bind(7)
    out.append(serve.run(serve.deployment(Fanout).options(
        name="Sharing").bind([shared, shared])).call())
    out.append(serve.run(serve.deployment(Holder).bind(
        Point(1, 2), (3, 4))).call())
    return out


def handle_uses_pushed_model_map(pkg, serve):
    cls = _per_package(serve, MuxJax, MuxTorch)
    handle = serve.run(serve.deployment(num_replicas=2)(cls).bind(),
                       name="mux_pushed")
    first = handle.options(multiplexed_model_id="m1").call({"x": 1})
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        handle._refresh(ttl=0)
        if handle._model_map.get("m1"):
            break
        time.sleep(0.1)
    return first, len(handle._model_map.get("m1", ()))


def handle_evicts_dead_replica(pkg, serve):
    handle = serve.run(serve.deployment(num_replicas=2)(WhoAmI).bind(),
                       name="who_evict")
    up = _wait_running(serve, "who_evict", 2)
    handle._refresh(ttl=0)
    victim = handle._replicas[0]
    pkg.kill(victim)
    # every call succeeds: the first failure evicts, retries land on the
    # survivor (or the reconciler's replacement)
    ok = all(handle.call("x") is not None for _ in range(10))
    return up, ok


def prefix_affinity_injected(pkg, serve):
    """A request carrying _prefix_tokens lands on the replica whose
    digest (put straight into the process's registry) holds its pages."""
    handle = serve.run(serve.deployment(num_replicas=2)(WhoAmI).bind(),
                       name="aff")
    up = _wait_running(serve, "aff", 2)
    handle._refresh(ttl=0)
    tags = sorted(handle._tags.values())
    toks = list(range(1, 65))
    router = jrouter if serve is jserve else trouter
    set_annex = (metrics_plane.set_annex if serve is jserve
                 else annex.set_annex)
    set_annex(router.DIGEST_PREFIX + tags[1], {
        "tag": tags[1], "deployment": "aff", "page_size": 8,
        "hashes": router.digest_hashes(toks, 8), "kv_free": 8,
        "kv_total": 16})
    want = {t: r for r, t in handle._tags.items()}[tags[1]]
    got = {pkg.get(handle.remote("x", _prefix_tokens=toks))
           for _ in range(6)}
    other = [r for r in handle._replicas if r != want][0]
    return up, tags, len(got), not handle._inflight.get(other)


SCENARIOS = [deploy_and_call, multiple_replicas_route, redeploy_updates,
             user_config_reconfigure, dynamic_batching,
             autoscaling_up_polled, http_proxy, delete_deployment,
             multiplexed_models, streaming, serve_status, graph_composition,
             handle_uses_pushed_model_map, handle_evicts_dead_replica,
             prefix_affinity_injected]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_serve(both, scenario):
    want = scenario(*both["jax"])
    jserve.shutdown()
    got = scenario(*both["torch"])
    assert got == want
    # and the JAX side itself shows the behaviour the scenario names
    expected = {
        deploy_and_call: [{"echo": "hi"}, 105, 42],
        multiple_replicas_route: True,
        redeploy_updates: "v2",
        user_config_reconfigure: 7,
        dynamic_batching: ([i * 2 for i in range(16)], True),
        autoscaling_up_polled: (True, "polled", ["ok"] * 12),
        http_proxy: ({"result": {"sum": 5}}, 200, 404),
        delete_deployment: ({"echo": 1}, "KeyError"),
        multiplexed_models: ([10, 20, 5, 3], ["m1", "m2"], ["m1", "m3"],
                             ["m7-0", "m7-1"]),
        streaming: ([i * i for i in range(30)], True, ["a", "b"], True),
        serve_status: (True, 2, 2),
        graph_composition: [
            "out:42", ["Model", "Pipeline", "Preprocess"], 10, [1, 2],
            "ValueError", [7, 7], ("Point", 3, (3, 4))],
        handle_uses_pushed_model_map: (1, 1),
        handle_evicts_dead_replica: (True, True),
        prefix_affinity_injected: (True, ["aff#r0", "aff#r1"], 1, True),
    }[scenario]
    assert want == expected


def test_a_body_pickle_cannot_carry_is_refused(both):
    class Local:
        def __call__(self):
            return 1

    with pytest.raises(TypeError, match="cannot reach its replicas"):
        tserve.run(tserve.deployment(Local).bind())


# --- prefix routing ---


def _digest(router, tag, tokens, page_size, *, n_pages=None, ts=None):
    hashes = router.digest_hashes(tokens, page_size)[:n_pages]
    return {"src": "test", "key": router.DIGEST_PREFIX + tag,
            "ts": time.time() if ts is None else ts,
            "payload": {"tag": tag, "deployment": "D",
                        "page_size": page_size, "hashes": hashes,
                        "kv_free": 8, "kv_total": 16}}


def _router_picks(router):
    toks = list(range(1, 33))
    out = {"hashes": router.digest_hashes(toks, 4)}
    r = router.PrefixRouter(ttl_s=60)
    r.ingest([_digest(router, "a", toks, 4, n_pages=2),
              _digest(router, "b", toks, 4, n_pages=6),
              _digest(router, "c", toks, 4, n_pages=3),
              _digest(router, "d", toks, 4, n_pages=3),
              _digest(router, "old", toks, 4, ts=time.time() - 100)])
    out["scores"] = [r.score(toks, t) for t in ("a", "b", "c", "old", "z")]
    out["picks"] = [r.pick(toks, {"a": 0, "b": 5}),
                    r.pick(toks, {"c": 7, "d": 1}),
                    r.pick(toks, {"c": 1, "d": 7}),
                    r.pick(list(range(100, 140)), {"a": 0, "b": 0}),
                    r.pick(toks, {"old": 0}),
                    r.pick(toks[:10], {"b": 0})]
    out["counts"] = (r.hits, r.fallbacks, r.digest_count())
    r.forget("b")
    out["after_forget"] = r.pick(toks, {"a": 0, "b": 0})
    return out


def test_prefix_router_picks_equal_across_packages():
    want, got = _router_picks(jrouter), _router_picks(trouter)
    assert got == want
    assert all(isinstance(h, int) for h in got["hashes"])
    assert want["scores"] == [2, 6, 3, 0, 0]
    assert want["picks"] == ["b", "d", "c", None, None, "b"]


def test_local_annex_registry_roundtrip():
    annex.set_annex("serve/prefix_digest/t0", {"tag": "t0"})
    annex.set_annex("other/x", {"tag": "x"})
    got = tstate.cluster_metric_annexes(trouter.DIGEST_PREFIX)
    assert [r["payload"]["tag"] for r in got] == ["t0"]
    assert tstate.cluster_metric_annexes("serve/", max_age_s=-1) == []
    annex.set_annex_provider("serve/prefix_digest/live", lambda: {"n": 1})
    assert {r["key"] for r in tstate.cluster_metric_annexes(
        trouter.DIGEST_PREFIX)} == {"serve/prefix_digest/t0",
                                    "serve/prefix_digest/live"}
    annex.set_annex_provider("serve/prefix_digest/live", None)
    annex.set_annex("serve/prefix_digest/t0", None)  # retract
    assert tstate.cluster_metric_annexes(trouter.DIGEST_PREFIX) == []


# --- the engines under Serve ---


@pytest.fixture(scope="module")
def tiny():
    """``llama_tiny`` in float32, JAX's weights carried over, the LM head
    sharpened 4x so that rounding cannot flip a near-tie argmax (as in
    tests/test_torch_serve.py)."""
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype="float32")
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    jparams["lm_head"] = jparams["lm_head"] * 4.0
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    MODELS.update(jax=(jcfg, jparams), torch=(tcfg, tparams))
    return MODELS


# the model builders reach replicas by reference: module-level functions
# over the weights built once
MODELS: dict = {}


def jax_tiny():
    return MODELS["jax"]


def torch_tiny():
    return MODELS["torch"]


def _engines(core, live=True) -> dict:
    """The engines of the LLM replicas (only the live ones with
    ``live``), by replica tag: the in-process runtime holds each
    replica's instance."""
    out = {}
    for state in list(core.get_runtime()._actors.values()):
        body = getattr(state.instance, "_instance", None)
        if hasattr(body, "_engine") and not (live and state.dead):
            out[state.instance._tag] = body._engine
    return out


def _stop_engines(core):
    """A killed replica's engine keeps running in the in-process runtime,
    as in the JAX package: stop them through the runtime's instances."""
    for eng in _engines(core, live=False).values():
        eng.stop()


def test_engine_publishes_the_same_digest(tiny):
    jcfg, jparams = tiny["jax"]
    tcfg, tparams = tiny["torch"]
    prompt = np.random.default_rng(3).integers(1, tcfg.vocab_size, 40)
    got = {}
    for name, eng, registry in (
            ("jax", JaxPagedLLMEngine(cfg=jcfg, params=jparams,
                                      max_batch=2, max_len=128,
                                      page_size=16), metrics_plane),
            ("torch", PagedLLMEngine(tcfg, tparams, max_batch=2,
                                     max_len=128, page_size=16,
                                     device="cpu"), annex)):
        req = eng.submit(prompt, max_new_tokens=4)
        eng.start()
        list(req.tokens())
        eng.stats()          # force a digest publish
        eng.stop()
        recs = {k: v for k, (_, v) in registry.local_annexes().items()
                if k.startswith(trouter.DIGEST_PREFIX)}
        assert list(recs) == [trouter.DIGEST_PREFIX + eng.replica_tag]
        payload = recs.popitem()[1]
        got[name] = {k: v for k, v in payload.items() if k != "tag"}
    # the retired slot's 2 own pages return to the free list on the
    # loop's idle pass, whose timing against stats() varies: 4 or 6 free
    assert got["jax"].pop("kv_free") in (4, 6)
    assert got["torch"].pop("kv_free") in (4, 6)
    assert got["torch"] == got["jax"]
    assert got["torch"]["hashes"] == trouter.digest_hashes(list(prompt), 16)
    assert got["torch"]["kv_total"] == 8
    assert got["torch"]["deployment"] == "-"


def test_llm_deployment_via_serve_matches_jax(both, tiny):
    """JAX's test_llm_deployment_via_serve path on both packages, on the
    same weights."""
    prompts = [[3, 17, 99], [5, 9, 13, 21, 34]]
    out = {}
    for name, builder, kw, core in (
            ("jax", jax_tiny, {}, jcore),
            ("torch", torch_tiny, {"device": "cpu"}, tcore)):
        pkg, serve = both[name]
        llm = (JaxLLMDeployment if name == "jax" else LLMDeployment)
        try:
            handle = serve.run(serve.deployment(llm).bind(
                builder, max_batch=2, max_len=64, **kw), name="llm")
            out[name] = [handle.call(p, max_new_tokens=4) for p in prompts]
            out[name].append(handle.options(method_name="stats").call()[
                "total_finished"])
        finally:
            _stop_engines(core)
            serve.shutdown()
    assert out["torch"] == out["jax"]
    assert out["jax"][-1] == 2 and all(len(t) == 4 for t in out["jax"][:2])


def test_prefix_affinity_end_to_end(both, tiny):
    """Two llama_tiny replicas: once one holds a prefix (its digest
    published), every request carrying that prefix goes to it, and its
    prefix-cache hits grow by the prefix's pages each time; the other
    replica's stay 0. A prompt whose first page differs scores 0 and
    hits nothing."""
    _, serve = both["torch"]
    tcfg = tiny["torch"][0]
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, tcfg.vocab_size, 32)       # 2 pages of 16
    tails = [rng.integers(1, tcfg.vocab_size, 5) for _ in range(5)]
    try:
        handle = serve.run(serve.deployment(num_replicas=2)(
            LLMDeployment).bind(torch_tiny, max_batch=2, max_len=64,
                                page_size=16, device="cpu"), name="aff_llm")
        assert _wait_running(serve, "aff_llm", 2)
        engines = _engines(tcore)
        assert sorted(engines) == ["aff_llm#r0", "aff_llm#r1"]
        first = np.concatenate([prefix, tails[0]]).tolist()
        handle.call(first, max_new_tokens=3, _prefix_tokens=first)
        time.sleep(0.3)   # one digest interval
        hits = {t: e.stats()["prefix_cache"]["hit_pages"]
                for t, e in engines.items()}
        holder = next(t for t, e in engines.items()
                      if e._prefix.evictable() + len(e._shared) > 0)
        other = next(t for t in engines if t != holder)
        assert hits == {holder: 0, other: 0}
        for tail in tails[1:]:
            prompt = np.concatenate([prefix, tail]).tolist()
            handle.call(prompt, max_new_tokens=3, _prefix_tokens=prompt)
            now = {t: e.stats()["prefix_cache"]["hit_pages"]
                   for t, e in engines.items()}
            assert now[holder] - hits[holder] >= 2
            assert now[other] == 0
            hits = now
        # control: one token of the first page changed
        control = np.concatenate([prefix, tails[1]])
        control[0] = (control[0] % (tcfg.vocab_size - 1)) + 1
        router = trouter.PrefixRouter()
        router.ingest(tstate.cluster_metric_annexes(trouter.DIGEST_PREFIX))
        assert router.score(control.tolist(), holder) == 0
        assert router.score(np.concatenate([prefix, tails[1]]).tolist(),
                            holder) == 2
        handle.call(control.tolist(), max_new_tokens=3,
                    _prefix_tokens=control.tolist())
        after = {t: e.stats()["prefix_cache"]["hit_pages"]
                 for t, e in engines.items()}
        assert after == hits
    finally:
        _stop_engines(tcore)
        serve.shutdown()


def test_serve_quickstart_prints_the_jax_examples_answers(capsys):
    """``examples/serve_quickstart.py``'s ``main()`` prints what the JAX
    example prints: the pipeline's direct and HTTP answers."""
    from ray_tpu.examples import serve_quickstart as jax_quickstart

    from ray_tpu_torch.examples import serve_quickstart

    jax_quickstart.main()
    want = capsys.readouterr().out
    got = serve_quickstart.main()
    assert capsys.readouterr().out == want
    assert want == ("direct call: {'sum': 12.0}\n"
                    "HTTP call: {'result': {'sum': 18.0}}\n")
    assert got == {"direct": {"sum": 12.0}, "http": {"result": {"sum": 18.0}}}
