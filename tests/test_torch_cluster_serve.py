"""Serve on the port's cluster runtime against the JAX package, on the CPU.

``serve.run`` of two ``LLMDeployment`` replicas of ``llama_tiny`` on a
``ray_tpu_torch.cluster_utils.Cluster``: the controller is a detached
actor in a worker process and each replica an actor in its own worker
process, while the handle stays here. The weights are JAX's, carried
across through ``convert.params_from_numpy`` out of an ``.npz`` file that
each replica reads through a module-level builder; the greedy tokens must
equal JAX's ``LLMDeployment``'s, bit for bit. The replicas' engines stop
with their processes: after ``serve.shutdown()`` and
``cluster.shutdown()`` no worker process is left.
"""

import dataclasses
import functools
import os
import time

import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMDeployment as JaxLLMDeployment
from ray_tpu_torch import convert, serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.llm import LLMDeployment

PROMPTS = [[3, 17, 99], [5, 9, 13, 21, 34], [7, 7, 7, 7]]
NEW_TOKENS = 4


def jax_tiny():
    """``llama_tiny`` in float32, the LM head sharpened 4x so that
    rounding cannot flip a near-tie argmax (as in
    tests/test_torch_serve.py)."""
    cfg = dataclasses.replace(jllama.llama_tiny(), dtype="float32")
    params = jllama.init_params(cfg, jax.random.key(0))
    params["lm_head"] = params["lm_head"] * 4.0
    return cfg, params


def npz_model(path: str):
    """The replicas' model builder: JAX's weights out of ``path``."""
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype="float32")
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    tree: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return cfg, convert.params_from_numpy(cfg, tree, device="cpu")


def save_npz(params, path: str):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(params, "")
    np.savez(path, **flat)


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def jax_tokens():
    cfg, params = jax_tiny()
    dep = JaxLLMDeployment(lambda: (cfg, params), max_batch=2, max_len=64)
    try:
        want = [dep(p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
    finally:
        dep._engine.stop()
    return params, want


def test_llm_deployment_replicas_in_worker_processes(jax_tokens, tmp_path):
    params, want = jax_tokens
    path = str(tmp_path / "llama_tiny.npz")
    save_npz(jax.tree.map(np.asarray, params), path)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    ray_tpu_torch.shutdown()
    cluster = Cluster()
    try:
        node = cluster.add_node(num_cpus=4)
        ray_tpu_torch.init(address=cluster.gcs_address)
        handle = serve.run(serve.deployment(LLMDeployment, num_replicas=2)
                           .bind(functools.partial(npz_model, path),
                                 max_batch=2, max_len=64, device="cpu"),
                           name="llm")
        got = [handle.call(p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
        refs = [handle.remote(p, max_new_tokens=NEW_TOKENS)
                for p in PROMPTS * 2]
        burst = ray_tpu_torch.get(refs, timeout=120)
        finished = handle.options(method_name="stats").call()[
            "total_finished"]
        with node.raylet.workers.lock:
            actors = [w.proc.pid for w in node.raylet.workers.workers
                      .values() if w.state == "actor" and w.proc]
        pids = set(actors)
        assert got == want
        assert burst == want * 2
        assert finished >= 1
        # the controller and both replicas: three worker processes
        assert len(pids) == 3 and os.getpid() not in pids
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    deadline = time.monotonic() + 10
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in pids if alive(p)]
