"""The port's prestart fork server (``runtime/prestart.py``).

The demand gate decides as JAX's for the same stream of spawn requests.
Then, on one in-process cluster of the port (its raylet's ``WorkerPool``
and ``PrestartManager`` inspectable, real template and worker processes
underneath), the scenarios of ``tests/test_prestart.py``: a forked worker
runs tasks with nothing of its template (no control fd, an empty fault
plane while the raylet's is armed), the Nth request justifies a
template, a killed template means cold spawns and a respawned template,
runtime envs never cross templates, and the template holds no CUDA and
no threads. Last the CUDA fork-safety refusal, with stand-ins where this
host has no card: a template in which ``torch.cuda.is_initialized()``
reads True, and one with a library named ``libcuda.so.1`` mapped, each
refuses to serve, and the pool cold-spawns instead.
"""

import os
import select
import signal
import subprocess
import time

import pytest

import ray_tpu_torch
from ray_tpu.runtime import prestart as jprestart
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.runtime import fault_injection as fi
from ray_tpu_torch.runtime import prestart as tprestart
from ray_tpu_torch.runtime.rpc import recv_msg
from ray_tpu_torch.runtime_env import env_key
from ray_tpu_torch.utils.config import get_config

import torch_runtime_tasks as tasks


class _StubPool:
    _node = None


def _gate(prestart_mod, monkeypatch) -> list:
    """Spawn requests for two env keys, the template spawn itself
    stubbed out: what the gate decided for each."""
    mgr = prestart_mod.PrestartManager(_StubPool())
    monkeypatch.setattr(mgr, "_get_template", lambda key, renv: None)
    out = []
    envs = [None, {"env_vars": {"A": "1"}}]
    for i in range(20):
        renv = envs[i % 3 == 0]
        got = mgr.fork_worker(renv, f"w{i}", None, None)
        out.append((got, sorted(mgr._justified), dict(mgr.stats)))
    return out


def test_demand_gate_decides_as_jax(monkeypatch):
    assert _gate(tprestart, monkeypatch) == _gate(jprestart, monkeypatch)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    c = Cluster()
    c.add_node(num_cpus=4)
    ray_tpu_torch.init(address=c.gcs_address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


@pytest.fixture
def pool(cluster):
    yield next(iter(cluster.nodes.values())).raylet.workers
    fi.plane.load_plan(None)


def _warm(mgr, key="", runtime_env=None, timeout=60.0):
    mgr.warm(runtime_env)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with mgr.lock:
            t = mgr.templates.get(key)
        if t is not None and t.poll_ready(timeout=0.2):
            return t
        time.sleep(0.05)
    raise AssertionError(f"template for key {key!r} never became ready")


def test_forked_worker_runs_tasks_with_fresh_state(pool):
    t = _warm(pool.prestart)
    st = t.status()
    assert st["ok"] and st["threads"] == 1
    assert st["torch_imported"] is False
    assert st["cuda_initialized"] is False and st["libcuda_mapped"] is False
    assert "ray_tpu_torch.runtime.rpc" in st["preloaded"]
    # a plan armed in the raylet's process is not a forked child's
    fi.plane.load_plan({"rules": [{"fault": "drop",
                                   "method": "never_called"}]})
    before = pool.prestart.stats["forked"]
    handle = pool.spawn(None)
    assert handle.forked
    assert pool.prestart.stats["forked"] == before + 1
    probe = ray_tpu_torch.remote(tasks.fork_probe)
    out = ray_tpu_torch.get([probe.remote() for _ in range(8)], timeout=60)
    forked = [r for r in out if r["child_info"] is not None]
    assert forked, "no probe ran on a forked worker"
    for r in forked:
        assert r["child_info"]["template_pid"] == t.proc.pid
        assert not r["zygote_fd_env"]
        assert not r["plane_active"] and r["plane_rules"] == 0


def test_raylet_warms_and_reports_its_template_over_rpc(cluster, pool):
    """``prestart_warm`` and ``prestart_status``: the template of a node
    that another process started (the CLI's) warmed and read by a
    driver."""
    from ray_tpu_torch.runtime.rpc import RpcClient

    raylet = RpcClient(next(iter(cluster.nodes.values())).address)
    try:
        warm = raylet.call("prestart_warm", timeout_s=60.0, timeout=90)
        status = raylet.call("prestart_status", timeout=30)["default"]
        info = raylet.call("node_info", timeout=30)["prestart"]
    finally:
        raylet.close()
    assert warm["ok"] and warm["ready"]
    assert status["pid"] == warm["pid"]
    assert status["torch_imported"] is False
    assert status["cuda_initialized"] is False
    assert info["templates"]["default"] == {"pid": warm["pid"],
                                            "ready": True, "alive": True}


def test_nth_request_justifies_a_template(pool):
    mgr = pool.prestart
    renv = {"env_vars": {"PRESTART_MARKER": "gate"}}
    key = env_key(renv)
    thresh = get_config().prestart_spawn_threshold
    for i in range(thresh - 1):
        assert mgr.fork_worker(renv, f"gate-{i}", None, None) is None
        with mgr.lock:
            assert key not in mgr.templates
    assert mgr.fork_worker(renv, "gate-n", None, None) is None
    with mgr.lock:
        assert key in mgr.templates


def test_template_crash_falls_back_to_cold_spawn(pool):
    mgr = pool.prestart
    t = _warm(mgr)
    spawns, cold = mgr.stats["template_spawns"], mgr.stats["cold_fallback"]
    os.kill(t.proc.pid, signal.SIGKILL)
    t.proc.wait(timeout=10)
    handle = pool.spawn(None)
    assert not handle.forked
    probe = ray_tpu_torch.remote(tasks.double)
    assert ray_tpu_torch.get([probe.remote(i) for i in range(4)],
                             timeout=60) == [0, 2, 4, 6]
    assert mgr.stats["cold_fallback"] > cold
    assert mgr.stats["template_deaths"] >= 1
    assert mgr.stats["template_spawns"] == spawns + 1
    with mgr.lock:
        t2 = mgr.templates.get("")
    assert t2 is not None and t2 is not t and t2.alive()


def test_env_keys_never_cross_templates(pool):
    mgr = pool.prestart
    env_a = {"env_vars": {"PRESTART_MARKER": "a"}}
    env_b = {"env_vars": {"PRESTART_MARKER": "b"}}
    ta = _warm(mgr, env_key(env_a), env_a)
    tb = _warm(mgr, env_key(env_b), env_b)
    assert ta.proc.pid != tb.proc.pid
    for renv, marker, template in ((env_a, "a", ta), (env_b, "b", tb)):
        f = ray_tpu_torch.remote(runtime_env=renv)(tasks.env_probe)
        out = ray_tpu_torch.get(f.remote("PRESTART_MARKER"), timeout=60)
        assert out["var"] == marker
        if out["forked_from"] is not None:
            assert out["forked_from"] == template.proc.pid


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """Two sitecustomize stand-ins for a card: one makes
    ``torch.cuda.is_initialized()`` read True, one maps a library named
    ``libcuda.so.1``."""
    root = tmp_path_factory.mktemp("standins")
    init = root / "initialized"
    init.mkdir()
    (init / "sitecustomize.py").write_text(
        "import torch\ntorch.cuda.is_initialized = lambda: True\n")
    mapped = root / "mapped"
    mapped.mkdir()
    src = root / "empty.cc"
    src.write_text("extern \"C\" int cu_stand_in() { return 0; }\n")
    lib = mapped / "libcuda.so.1"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    (mapped / "sitecustomize.py").write_text(
        f"import ctypes\nctypes.CDLL({str(lib)!r})\n")
    return {"torch.cuda.is_initialized() is True": str(init),
            "libcuda is mapped": str(mapped)}


def _first_frame(t, timeout=60.0) -> dict:
    r, _, _ = select.select([t.sock], [], [], timeout)
    assert r, "template sent nothing"
    t.sock.settimeout(5.0)
    return recv_msg(t.sock)


def test_template_refuses_to_fork_with_cuda(pool, standins, monkeypatch):
    mgr = pool.prestart
    base = mgr._base_env()
    for reason, path in standins.items():
        env = dict(base, PYTHONPATH=path + os.pathsep + base["PYTHONPATH"])
        t = tprestart.ZygoteTemplate("standin", None, env, None).start()
        try:
            frame = _first_frame(t)
            assert frame == {"ready": False,
                             "error": f"CUDA in template: {reason}"}
            assert t.proc.wait(timeout=30) == 1
        finally:
            t.close()
            t.reap()
    # the pool's templates for a key whose template refuses: every spawn
    # is cold, and the work still runs
    path = standins["libcuda is mapped"]
    real = mgr._base_env

    def standin_env():
        env = real()
        env["PYTHONPATH"] = path + os.pathsep + env["PYTHONPATH"]
        return env

    monkeypatch.setattr(mgr, "_base_env", standin_env)
    renv = {"env_vars": {"PRESTART_MARKER": "refused"}}
    t = mgr.warm(renv)
    assert t.proc.wait(timeout=60) == 1
    assert not t.poll_ready()
    cold = mgr.stats["cold_fallback"]
    forked = mgr.stats["forked"]
    f = ray_tpu_torch.remote(runtime_env=renv)(tasks.env_probe)
    out = ray_tpu_torch.get(f.remote("PRESTART_MARKER"), timeout=60)
    assert out["var"] == "refused" and out["forked_from"] is None
    assert mgr.stats["forked"] == forked
    assert mgr.stats["cold_fallback"] > cold


def test_cuda_check_of_a_process_without_torch():
    """A fresh interpreter that imports the prestart module (as a
    template does) has no torch and no libcuda."""
    import json
    import sys

    probe = ("import json, os\n"
             "from ray_tpu_torch.runtime import prestart as p\n"
             "print(json.dumps([p.cuda_in_process(), p.libcuda_mapped(),"
             " p.libcuda_mapped(os.getpid()),"
             " 'torch' in __import__('sys').modules]))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [None, False, False, False]
