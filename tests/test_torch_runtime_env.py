"""The port's runtime environments (``ray_tpu_torch/runtime_env.py``).

``RuntimeEnv`` validates the same inputs into the same dicts and the same
errors as JAX's, with the same worker-cache keys, and the pure plugin
helpers (content-addressed snapshots, conda command lines, the container
command) agree. On the in-process runtime a task or actor sees its
``env_vars`` only while it runs, and its ``py_modules`` import. On one
port cluster (the scenarios of ``tests/test_runtime_env.py``): envs get
workers of their own and reuse them, a ``working_dir`` becomes the
worker's cwd, ``py_modules`` import, a local wheel installs into a cached
venv that only its env sees, and a bad pip requirement, a missing conda
and a missing container runtime each fail fast with
``RuntimeEnvSetupError``.
"""

import base64
import hashlib
import os
import shutil
import sys
import time
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu import runtime_env as jenv
from ray_tpu_torch import runtime_env as tenv
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.utils.exceptions import RuntimeEnvSetupError

import torch_runtime_tasks as tasks


def _outcome(mod, kwargs):
    try:
        env = mod.RuntimeEnv(**kwargs)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return dict(env), mod.env_key(env)


def test_validation_and_keys_match_jax(tmp_path):
    (tmp_path / "wd").mkdir()
    cases = [
        {}, {"pip": ["requests"]}, {"pip": {"packages": ["x", "./local"]}},
        {"pip": [1, 2]}, {"bogus_field": 1},
        {"working_dir": str(tmp_path / "missing")},
        {"working_dir": str(tmp_path / "wd")},
        {"env_vars": {"A": 1}}, {"env_vars": {"A": "1"}, "config": {"x": 2}},
        {"py_modules": [str(tmp_path / "m")]},
        {"conda": "base"}, {"conda": {"dependencies": ["numpy=1.26"]}},
        {"conda": {"name": "x"}}, {"conda": 3},
        {"container": {"image": "python:3.12", "run_options": ["--gpus=all"]}},
        {"container": {"run_options": []}},
        {"container": {"image": "i", "run_options": [1]}},
    ]
    for kwargs in cases:
        assert _outcome(tenv, kwargs) == _outcome(jenv, kwargs), kwargs
    assert tenv.env_key(None) == "" == tenv.env_key({})


def test_plugin_helpers_match_jax(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    (d / "f.txt").write_text("hello")
    assert tenv._dir_content_hash(str(d)) == jenv._dir_content_hash(str(d))
    monkeypatch.setenv("RAY_TPU_TORCH_RUNTIME_ENV_CACHE",
                       str(tmp_path / "cache"))
    s1 = tenv.snapshot_dir(str(d))
    assert s1 == tenv.snapshot_dir(str(d))
    assert s1.startswith(str(tmp_path / "cache"))
    (d / "f.txt").write_text("changed")
    assert tenv.snapshot_dir(str(d)) != s1
    spec = {"dependencies": ["numpy", "pandas=2.2", {"pip": ["x"]}]}
    assert (tenv.conda_create_commands(spec, "/c/abc", "/opt/conda")
            == jenv.conda_create_commands(spec, "/c/abc", "/opt/conda"))
    cmd = tenv.container_command(
        {"image": "my/img:1", "run_options": ["--memory=4g"]},
        ["python", "-m", "ray_tpu_torch.runtime.worker_main"],
        {"RAY_TPU_TORCH_RAYLET_HOST": "127.0.0.1", "HOME": "/root",
         "CUDA_VISIBLE_DEVICES": "0"},
        runtime="docker", mounts=["/data"])
    assert cmd[:2] == ["docker", "run"]
    assert "--network=host" in cmd and "--ipc=host" in cmd
    assert "-e=RAY_TPU_TORCH_RAYLET_HOST=127.0.0.1" in cmd
    assert "-e=CUDA_VISIBLE_DEVICES=0" in cmd
    assert not any(c.startswith("-e=HOME") for c in cmd)
    assert cmd.index("my/img:1") > cmd.index("--memory=4g")
    assert cmd[-3:] == ["python", "-m", "ray_tpu_torch.runtime.worker_main"]


def test_in_process_env_vars_and_py_modules(tmp_path):
    mod = tmp_path / "rtt_local_rtenv"
    mod.mkdir()
    (mod / "__init__.py").write_text("VALUE = 41\n")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        f = ray_tpu_torch.remote(
            runtime_env={"env_vars": {"RTT_VAR": "abc"}})(tasks.env_probe)
        g = ray_tpu_torch.remote(tasks.env_probe)
        assert ray_tpu_torch.get(f.remote("RTT_VAR"))["var"] == "abc"
        assert ray_tpu_torch.get(g.remote("RTT_VAR"))["var"] is None
        a = ray_tpu_torch.remote(
            runtime_env={"env_vars": {"RTT_ACTOR": "z"}})(_Peek).remote()
        assert ray_tpu_torch.get(a.peek.remote("RTT_ACTOR")) == "z"
        m = ray_tpu_torch.remote(
            runtime_env={"py_modules": [str(mod)]})(tasks.env_probe)
        assert ray_tpu_torch.get(
            m.remote(module="rtt_local_rtenv"))["module"] == 41
    finally:
        sys.modules.pop("rtt_local_rtenv", None)
        ray_tpu_torch.shutdown()


class _Peek:
    def peek(self, name):
        return os.environ.get(name)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    cache = tmp_path_factory.mktemp("renv_cache")
    saved = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV_CACHE")
    os.environ["RAY_TPU_TORCH_RUNTIME_ENV_CACHE"] = str(cache)
    ray_tpu_torch.shutdown()
    c = Cluster()
    c.add_node(num_cpus=4)
    ray_tpu_torch.init(address=c.gcs_address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()
    if saved is None:
        os.environ.pop("RAY_TPU_TORCH_RUNTIME_ENV_CACHE", None)
    else:
        os.environ["RAY_TPU_TORCH_RUNTIME_ENV_CACHE"] = saved


def test_cluster_envs_get_their_own_workers(cluster, tmp_path):
    fa = ray_tpu_torch.remote(
        runtime_env={"env_vars": {"WORKER_FLAVOR": "a"}})(tasks.fork_probe)
    fb = ray_tpu_torch.remote(
        runtime_env={"env_vars": {"WORKER_FLAVOR": "b"}})(tasks.env_probe)
    pa = ray_tpu_torch.get(fa.remote(), timeout=60)["pid"]
    vb = ray_tpu_torch.get(fb.remote("WORKER_FLAVOR"), timeout=60)
    assert vb["var"] == "b"
    assert ray_tpu_torch.get(fa.remote(), timeout=60)["pid"] == pa
    # working_dir: the worker runs in a copy of the snapshot
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "data.txt").write_text("payload")
    mod = tmp_path / "rtt_cluster_rtenv"
    mod.mkdir()
    (mod / "__init__.py").write_text("VALUE = 7\n")
    f = ray_tpu_torch.remote(runtime_env={
        "working_dir": str(wd), "py_modules": [str(mod)]})(tasks.env_probe)
    out = ray_tpu_torch.get(f.remote(module="rtt_cluster_rtenv"), timeout=60)
    assert out["cwd_files"] == ["data.txt"]
    assert out["module"] == 7


def _tiny_wheel(path) -> str:
    """A hand-assembled wheel: installs offline with no build backend."""
    whl = path / "tinytorchlib-0.0.1-py3-none-any.whl"
    files = {
        "tinytorchlib/__init__.py": b"VALUE = 'tiny-42'\n",
        "tinytorchlib-0.0.1.dist-info/METADATA":
            b"Metadata-Version: 2.1\nName: tinytorchlib\nVersion: 0.0.1\n",
        "tinytorchlib-0.0.1.dist-info/WHEEL":
            b"Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true"
            b"\nTag: py3-none-any\n",
    }
    rows = []
    for name, data in files.items():
        digest = base64.urlsafe_b64encode(
            hashlib.sha256(data).digest()).rstrip(b"=").decode()
        rows.append(f"{name},sha256={digest},{len(data)}")
    rows.append("tinytorchlib-0.0.1.dist-info/RECORD,,")
    with zipfile.ZipFile(whl, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
        z.writestr("tinytorchlib-0.0.1.dist-info/RECORD",
                   "\n".join(rows) + "\n")
    return str(whl)


def test_cluster_pip_local_wheel_and_fast_failures(cluster, tmp_path,
                                                   monkeypatch):
    wheel = _tiny_wheel(tmp_path)
    f = ray_tpu_torch.remote(runtime_env={"pip": [wheel]})(tasks.env_probe)
    out = ray_tpu_torch.get(f.remote(module="tinytorchlib"), timeout=300)
    assert out["module"] == "tiny-42"
    plain = ray_tpu_torch.remote(tasks.env_probe)
    with pytest.raises(Exception, match="tinytorchlib"):
        ray_tpu_torch.get(plain.remote(module="tinytorchlib"), timeout=60)
    start = time.monotonic()
    broken = ray_tpu_torch.remote(runtime_env={
        "pip": ["/definitely/not/a/package/path"]})(tasks.double)
    with pytest.raises(RuntimeEnvSetupError,
                       match="runtime env setup failed"):
        ray_tpu_torch.get(broken.remote(1), timeout=120)
    # no conda and no container runtime on this host: both fail fast
    monkeypatch.delenv("CONDA_EXE", raising=False)
    if not (shutil.which("conda") or shutil.which("mamba")
            or shutil.which("micromamba")):
        conda = ray_tpu_torch.remote(runtime_env={
            "conda": {"dependencies": ["numpy"]}})(tasks.double)
        with pytest.raises(RuntimeEnvSetupError, match="conda"):
            ray_tpu_torch.get(conda.remote(1), timeout=120)
    if not (shutil.which("docker") or shutil.which("podman")):
        boxed = ray_tpu_torch.remote(runtime_env={
            "container": {"image": "python:3.12"}})(tasks.double)
        with pytest.raises(RuntimeEnvSetupError, match="docker/podman"):
            ray_tpu_torch.get(boxed.remote(1), timeout=120)
    assert time.monotonic() - start < 90
