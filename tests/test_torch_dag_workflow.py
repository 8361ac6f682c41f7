"""The port's ``dag`` and ``workflow`` (``ray_tpu_torch/dag``,
``ray_tpu_torch/workflow``) and ``RemoteFunction.bind`` against the JAX
package's on the CPU: the scenarios of ``tests/test_util.py``'s
``test_dag_*`` and ``test_workflow_run_and_resume`` and of
``tests/test_workflow_extras.py``, each run through both packages on
their in-process runtimes, with equal results and the JAX tests'
assertions on each. The step ids are content-addressed in both, but the
port digests what a step captured (closure cells, defaults) where JAX
hashes the function with cloudpickle: an edited default gives a new id,
and an unrelated new step leaves the other ids alone.
"""

import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import dag as jdag
from ray_tpu import workflow as jworkflow
from ray_tpu_torch import dag as tdag
from ray_tpu_torch import workflow as tworkflow

PACKAGES = {"jax": (ray_tpu, jdag, jworkflow),
            "torch": (ray_tpu_torch, tdag, tworkflow)}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _both(scenario, tmp_path):
    out = {name: scenario(*mods, tmp_path / name)
           for name, mods in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def dag_bind_execute(rt, dag, wf, tmp):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def mul(a, b):
        return a * b

    node = mul.bind(add.bind(1, 2), add.bind(3, 4))
    return (rt.get(node.execute()), type(node).__name__,
            [n._fn.__name__ for n in node.topo_order()])


def dag_diamond(rt, dag, wf, tmp):
    @rt.remote
    def one():
        return 1

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def add(a, b):
        return a + b

    base = one.bind()
    node = add.bind(inc.bind(base), inc.bind(base))
    return rt.get(node.execute()), len(node.topo_order())


def dag_functional_bind_and_input(rt, dag, wf, tmp):
    def add(a, b):
        return a + b

    inp = dag.InputNode()
    node = dag.bind(add, dag.bind(add, inp, 1), 10)
    with pytest.raises(TypeError):
        inp.execute()
    opts = rt.remote(num_cpus=1)(add).bind(2, 3)
    return (rt.get(dag.execute_with_input(node, 5)),
            rt.get(opts.execute()), opts._options)


def workflow_run_and_resume(rt, dag, wf, tmp):
    log = tmp / "calls.txt"
    tmp.mkdir(parents=True)

    @rt.remote
    def double(x):
        with open(str(log), "a") as f:
            f.write("c")
        return x * 2

    @rt.remote
    def add(a, b):
        return a + b

    node = add.bind(double.bind(10), double.bind(20))
    out = wf.run(node, workflow_id="wf1", storage=str(tmp))
    status = wf.status("wf1", storage=str(tmp))
    before = log.read_text().count("c")
    again = wf.resume(node, workflow_id="wf1", storage=str(tmp))
    meta = wf.metadata("wf1", storage=str(tmp))
    return (out, status, before, again, log.read_text().count("c"),
            meta["status"], len(meta["steps_completed"]),
            wf.list_all(storage=str(tmp)), wf.get_output(
                "wf1", storage=str(tmp)))


def step_retries(rt, dag, wf, tmp):
    tmp.mkdir(parents=True)
    marker = tmp / "attempts"

    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError("flake")
        return "ok"

    out = wf.run(dag.DAGNode(flaky, (), {}).options(workflow_max_retries=3),
                 workflow_id="wf_retry", storage=str(tmp / "st"))
    return out, int(marker.read_text())


def step_retries_exhausted(rt, dag, wf, tmp):
    def always_fails():
        raise RuntimeError("perma")

    with pytest.raises(Exception, match="perma") as info:
        wf.run(dag.DAGNode(always_fails, (), {}).options(
            workflow_max_retries=1), workflow_id="wf_fail",
            storage=str(tmp / "st"))
    return (type(info.value).__name__,
            wf.status("wf_fail", storage=str(tmp / "st")))


def catch_exceptions_saga(rt, dag, wf, tmp):
    def boom():
        raise ValueError("expected")

    def compensate(res):
        value, err = res
        return f"compensated:{type(err).__name__}" if err else value

    failing = dag.DAGNode(boom, (), {}).options(
        workflow_catch_exceptions=True)
    return wf.run(dag.DAGNode(compensate, (failing,), {}),
                  workflow_id="wf_saga", storage=str(tmp / "st"))


def run_async_and_get_output(rt, dag, wf, tmp):
    def slow(x):
        time.sleep(0.05)
        return x * 2

    ref = wf.run_async(dag.DAGNode(slow, (21,), {}), workflow_id="wf_async",
                       storage=str(tmp / "st"))
    value = rt.get(ref, timeout=30)
    meta = wf.metadata("wf_async", storage=str(tmp / "st"))
    return (value, wf.get_output("wf_async", storage=str(tmp / "st")),
            meta["status"], len(meta["steps_completed"]))


def event_trigger_and_timeout(rt, dag, wf, tmp):
    def after(payload):
        return b"payload:" + payload

    node = dag.DAGNode(after, (wf.event("go", timeout_s=10),), {})

    def fire():
        time.sleep(0.2)
        wf.signal_event("go", b"fired")

    threading.Thread(target=fire, daemon=True).start()
    out = wf.run(node, workflow_id="wf_event", storage=str(tmp / "st"))
    with pytest.raises(Exception, match="never fired") as info:
        wf.run(wf.event("never", timeout_s=0.2), workflow_id="wf_event_t",
               storage=str(tmp / "st"))
    return out, type(info.value).__name__


SCENARIOS = [dag_bind_execute, dag_diamond, dag_functional_bind_and_input,
             workflow_run_and_resume, step_retries, step_retries_exhausted,
             catch_exceptions_saga, run_async_and_get_output,
             event_trigger_and_timeout]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(runtimes, tmp_path, scenario):
    _both(scenario, tmp_path)


def test_jax_assertions_hold_on_the_port(runtimes, tmp_path):
    rt, dag, wf = PACKAGES["torch"]
    assert dag_bind_execute(rt, dag, wf, tmp_path / "a")[0] == 21
    assert dag_diamond(rt, dag, wf, tmp_path / "b")[0] == 4
    out, status, before, again, after, *_ = workflow_run_and_resume(
        rt, dag, wf, tmp_path / "c")
    assert (out, status, again) == (60, "SUCCESS", 60) and after == before
    assert step_retries(rt, dag, wf, tmp_path / "d") == ("ok", 3)
    assert step_retries_exhausted(rt, dag, wf, tmp_path / "e")[1] == \
        "FAILED"
    assert catch_exceptions_saga(rt, dag, wf, tmp_path / "f") == \
        "compensated:ValueError"
    assert run_async_and_get_output(rt, dag, wf, tmp_path / "g")[:3] == \
        (42, 42, "SUCCESS")
    assert event_trigger_and_timeout(rt, dag, wf, tmp_path / "h")[0] == \
        b"payload:fired"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_step_ids_are_content_addressed(runtimes, tmp_path, pkg):
    """``tests/test_workflow_extras.py``'s property in each package: an
    unrelated new step reuses the other step's checkpoint, a changed
    input re-runs it. In the port also: the ids of a DAG's steps do not
    move when an unrelated step joins, and an edited default or captured
    value gives a new id (JAX's bytecode fallback, taken where
    cloudpickle does not import, misses both)."""
    rt, dag, wf = PACKAGES[pkg]
    marker = str(tmp_path / "expensive_calls")

    def expensive(x, _marker=marker):
        with open(_marker, "a") as f:
            f.write("x")
        return x * 10

    def cheap(x):
        return x + 1

    def combine(a, b=0):
        return a + b

    def n_calls():
        import os
        return os.path.getsize(marker) if os.path.exists(marker) else 0

    store = str(tmp_path / "st")
    dag1 = dag.DAGNode(combine, (dag.DAGNode(expensive, (4,), {}),), {})
    assert wf.run(dag1, workflow_id="wf_ca", storage=store) == 40
    assert n_calls() == 1
    dag2 = dag.DAGNode(combine, (dag.DAGNode(expensive, (4,), {}),),
                       {"b": dag.DAGNode(cheap, (1,), {})})
    assert wf.run(dag2, workflow_id="wf_ca", storage=store) == 42
    assert n_calls() == 1, "checkpoint was not reused"
    dag3 = dag.DAGNode(combine, (dag.DAGNode(expensive, (5,), {}),), {})
    assert wf.run(dag3, workflow_id="wf_ca", storage=store) == 50
    assert n_calls() == 2
    if pkg != "torch":
        return

    def ids(node):
        order = node.topo_order()
        got = wf._step_ids(order)
        return {n._fn.__name__: got[id(n)] for n in order}

    a, b = ids(dag1), ids(dag2)
    assert a["expensive"] == b["expensive"]
    assert a["combine"] != b["combine"]

    def expensive_elsewhere(x, _marker=marker + ".other"):
        return x * 10

    def with_default(default):
        def step(x, k=default):
            return x + k
        return step

    def captured(value):
        def step(x):
            return x + value
        return step

    def one(fn):
        return ids(dag.DAGNode(fn, (1,), {}))[fn.__name__]

    assert one(with_default(1)) != one(with_default(2))
    assert one(with_default(1)) == one(with_default(1))
    assert one(captured(1)) != one(captured(2))
    assert one(captured(1)) == one(captured(1))
    assert ids(dag.DAGNode(expensive_elsewhere, (4,), {}))[
        "expensive_elsewhere"] != a["expensive"]


def test_dag_and_workflow_export_the_jax_names():
    for jmod, tmod in ((jdag, tdag), (jworkflow, tworkflow)):
        names = {n for n, v in vars(jmod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == jmod.__name__}
        assert names, jmod
        for n in names:
            assert hasattr(tmod, n), (tmod.__name__, n)
    assert hasattr(ray_tpu_torch.api.RemoteFunction, "bind")
