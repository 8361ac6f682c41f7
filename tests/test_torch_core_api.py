"""The port's core API on its in-process runtime against the JAX package's.

Each scenario (drawn from tests/test_core_api.py and the local-mode cases
of tests/test_async_streaming.py) runs once on ``ray_tpu`` and once on
``ray_tpu_torch``, each on its own in-process runtime, and must give the
same result. Then the port's own surface: the ``GPU`` resource, and the
refusals of ``runtime_env`` and ``address=``.
"""

import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.runtime.streaming import ObjectRefGenerator as JaxGenerator
from ray_tpu_torch.runtime.streaming import ObjectRefGenerator

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def runtimes():
    """Both in-process runtimes, started once for the module."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield PACKAGES
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


# --- bodies shared by both packages (module level: each package's
# ``remote`` wraps them) ---


def _add(a, b=10):
    return a + b


def _double(x):
    return 2 * x


def _three():
    return 1, 2, 3


def _boom():
    raise ValueError("kapow")


def _sleep_return(t):
    time.sleep(t)
    return t


def _letters():
    yield "a"
    yield "b"


def _dies_midstream():
    yield 1
    yield 2
    raise RuntimeError("stream died")


class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def fail(self):
        raise RuntimeError("actor method failed")


class AsyncWorker:
    def __init__(self):
        self.peak = 0
        self.live = 0

    async def slow(self, delay):
        import asyncio

        self.live += 1
        self.peak = max(self.peak, self.live)
        await asyncio.sleep(delay)
        self.live -= 1
        return self.peak


class Sleeper:
    def block(self, t):
        return _sleep_return(t)


class Broken:
    def __init__(self):
        raise RuntimeError("bad init")

    def ping(self):
        return "pong"


def _error_name(fn) -> str:
    """The class name of what ``fn()`` raises (each package raises its own
    classes of the same names)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "no error"


# --- scenarios: each returns what both packages must agree on ---


def tasks_with_dependencies(pkg):
    add, double = pkg.remote(_add), pkg.remote(_double)
    three = pkg.remote(num_returns=3)(_three)
    chained = double.remote(double.remote(double.remote(1)))
    a, b, c = three.remote()
    return {
        "kwargs": pkg.get([add.remote(2, b=3), add.remote(2)]),
        "chain": pkg.get(chained),
        "ref_arg": pkg.get(add.remote(pkg.put(5), double.remote(4))),
        "num_returns": pkg.get([a, b, c]),
        "parallel": pkg.get([double.remote(i) for i in range(100)]),
        "put_of_a_ref": _error_name(lambda: pkg.put(pkg.put(1))),
    }


def actor_state(pkg):
    cls = pkg.remote(Counter)
    c = cls.remote(100)
    ordered = pkg.get([c.incr.remote() for _ in range(50)])
    err = _error_name(lambda: pkg.get(c.fail.remote()))
    return {"ordered": ordered, "after_error": pkg.get(c.incr.remote(5)),
            "error": err,
            "ref_arg": pkg.get(c.incr.remote(pkg.remote(_double).remote(3))),
            "init_failure": _error_name(
                lambda: pkg.get(pkg.remote(Broken).remote().ping.remote()))}


def named_actors_in_namespaces(pkg):
    cls = pkg.remote(Counter)
    cls.options(name="shared", namespace="a").remote(1)
    cls.options(name="shared", namespace="b").remote(2)
    cls.options(name="plain").remote(3)
    return {
        "a": pkg.get(pkg.get_actor("shared", namespace="a").value.remote()),
        "b": pkg.get(pkg.get_actor("shared", namespace="b").value.remote()),
        "default": pkg.get(pkg.get_actor("plain").value.remote()),
        "duplicate": _error_name(
            lambda: cls.options(name="shared", namespace="a").remote()),
        "missing": _error_name(lambda: pkg.get_actor("shared")),
    }


def async_actor_overlapping_awaits(pkg):
    a = pkg.remote(AsyncWorker).remote()
    t0 = time.monotonic()
    peaks = pkg.get([a.slow.remote(0.3) for _ in range(4)])
    elapsed = time.monotonic() - t0
    # four 0.3 s awaits overlapping: far below the 1.2 s serial floor
    return {"overlapped": elapsed < 1.0, "peak_at_least_3": max(peaks) >= 3}


def wait_and_get_timeout(pkg):
    sleep = pkg.remote(_sleep_return)
    fast, slow = sleep.remote(0.0), sleep.remote(2.0)
    ready, not_ready = pkg.wait([slow, fast], num_returns=1, timeout=1.5)
    both, _ = pkg.wait([fast, pkg.put(7)], num_returns=2)
    return {"ready": pkg.get(ready), "not_ready": len(not_ready),
            "both": pkg.get(both),
            "timeout": _error_name(lambda: pkg.get(slow, timeout=0.05)),
            "too_many": _error_name(lambda: pkg.wait([fast], num_returns=2))}


def kill_actor(pkg):
    c = pkg.remote(Counter).remote()
    first = pkg.get(c.incr.remote())
    pkg.kill(c)
    return {"first": first,
            "after_kill": _error_name(lambda: pkg.get(c.incr.remote()))}


def streaming_generator(pkg):
    gen = pkg.remote(num_returns="streaming")(_letters).remote()
    out = {"generator": type(gen).__name__,
           "values": [pkg.get(r) for r in gen],
           "dynamic": [pkg.get(r) for r in pkg.remote(
               num_returns="dynamic")(_letters).remote()]}
    it = iter(pkg.remote(num_returns="streaming")(_dies_midstream).remote())
    out["before_error"] = [pkg.get(next(it)), pkg.get(next(it))]
    try:
        pkg.get(next(it))
        out["midstream"] = "no error"
    except Exception as e:  # noqa: BLE001
        out["midstream"] = ("stream died" in str(e), type(e).__name__)
    out["after_error"] = _error_name(lambda: next(it))
    out["bad_num_returns"] = _error_name(
        lambda: pkg.remote(_add).options(num_returns="bogus").remote(1))
    return out


def error_crosses_get(pkg):
    chained = pkg.remote(_double).remote(pkg.remote(_boom).remote())
    out = {}
    for name, ref in (("direct", pkg.remote(_boom).remote()),
                      ("through_a_dependency", chained)):
        try:
            pkg.get(ref)
        except Exception as e:  # noqa: BLE001
            out[name] = (type(e).__name__, type(e.cause).__name__,
                         "kapow" in str(e))
    out["direct_call"] = _error_name(lambda: pkg.remote(_add)(1))
    return out


SCENARIOS = [tasks_with_dependencies, actor_state, named_actors_in_namespaces,
             async_actor_overlapping_awaits, wait_and_get_timeout,
             kill_actor, streaming_generator, error_crosses_get]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_jax_runtime(runtimes, scenario):
    want = scenario(runtimes["jax"])
    got = scenario(runtimes["torch"])
    assert got == want
    # and the JAX side itself shows the behaviour the scenario names
    if scenario is tasks_with_dependencies:
        assert want["chain"] == 8 and want["num_returns"] == [1, 2, 3]
        assert want["put_of_a_ref"] == "TypeError"
    if scenario is async_actor_overlapping_awaits:
        assert want == {"overlapped": True, "peak_at_least_3": True}
    if scenario is wait_and_get_timeout:
        assert want["ready"] == [0.0] and want["timeout"] == "GetTimeoutError"
    if scenario is kill_actor:
        assert want["after_kill"] == "ActorDiedError"
    if scenario is error_crosses_get:
        assert want["direct"] == ("TaskError", "ValueError", True)


def test_streaming_generator_type(runtimes):
    gen = ray_tpu_torch.remote(num_returns="streaming")(_letters).remote()
    assert isinstance(gen, ObjectRefGenerator)
    assert not isinstance(gen, JaxGenerator)
    assert [ray_tpu_torch.get(r) for r in gen] == ["a", "b"]


def test_max_concurrency_runs_calls_together(runtimes):
    p = ray_tpu_torch.remote(max_concurrency=4)(Sleeper).remote()
    t0 = time.monotonic()
    ray_tpu_torch.get([p.block.remote(0.2) for _ in range(4)])
    assert time.monotonic() - t0 < 0.6


def test_gpu_resource_and_its_count():
    """``init(num_gpus=0)`` registers ``GPU`` 0; without ``num_gpus`` the
    count is torch's, read without initializing CUDA."""
    import torch

    ray_tpu_torch.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        assert ray_tpu_torch.cluster_resources()["GPU"] == 0.0
        assert ray_tpu_torch.available_resources()["CPU"] == 2.0
        with pytest.raises(ValueError, match="exceeds cluster capacity"):
            ray_tpu_torch.remote(num_gpus=1)(_add).remote(1)
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=2)
        assert ray_tpu_torch.cluster_resources()["GPU"] == float(
            torch.cuda.device_count())
        assert not torch.cuda.is_initialized()
        ctx = ray_tpu_torch.get_runtime_context()
        assert ctx.get_job_id() and ctx.namespace.startswith("job-")
    finally:
        ray_tpu_torch.shutdown()


def test_runtime_env_and_address_raise():
    ray_tpu_torch.shutdown()
    try:
        with pytest.raises(NotImplementedError, match="cluster runtime"):
            ray_tpu_torch.init(address="127.0.0.1:6379")
        assert not ray_tpu_torch.is_initialized()
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        with pytest.raises(NotImplementedError, match="runtime_env"):
            ray_tpu_torch.remote(runtime_env={"env_vars": {"A": "1"}})(_add)
        with pytest.raises(NotImplementedError, match="runtime_env"):
            ray_tpu_torch.remote(runtime_env={"pip": ["x"]})(Counter).remote()
        # an empty environment is no environment
        f = ray_tpu_torch.remote(runtime_env={})(_add)
        assert ray_tpu_torch.get(f.remote(1)) == 11
        with pytest.raises(ValueError, match="Invalid task options"):
            ray_tpu_torch.remote(num_tpus=1)(_add)
    finally:
        ray_tpu_torch.shutdown()
