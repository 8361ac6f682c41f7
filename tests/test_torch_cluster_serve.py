"""Serve on the port's cluster runtime against the JAX package, on the CPU.

``serve.run`` of two ``LLMDeployment`` replicas of ``llama_tiny`` on a
``ray_tpu_torch.cluster_utils.Cluster``: the controller is a detached
actor in a worker process and each replica an actor in its own worker
process, while the handle stays here. The weights are JAX's, carried
across through ``convert.params_from_numpy`` out of an ``.npz`` file that
each replica reads through a module-level builder; the greedy tokens must
equal JAX's ``LLMDeployment``'s, bit for bit. Then the metrics plane
across processes: the replicas' pushers ship their prefix digests to the
GCS, so requests on a fresh shared prefix land on the replica that holds
it after the first (cross-process prefix affinity, its hit pages grow
and the other's do not); each replica's ``ray_tpu_serve_stage_s`` counts
in the GCS equal the requests it served and its four stages' sums add up
to its TTFTs; its ``ray_tpu_serve_kv_pages`` total is its pool. The
replicas' engines stop with their processes: after ``serve.shutdown()``
and ``cluster.shutdown()`` no worker process is left.
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
from ray_tpu_torch.serve.prefix_router import DIGEST_PREFIX, digest_hashes
from ray_tpu_torch.util import state
from ray_tpu_torch.utils.config import get_config

PROMPTS = [[3, 17, 99], [5, 9, 13, 21, 34], [7, 7, 7, 7]]
NEW_TOKENS = 4
# prefix affinity: pages of 16 tokens, a fresh two-page prefix and the
# requests that carry it after the first
PAGE = 16
AFFINITY_REQUESTS = 4
# a pool that holds the cached prefix beside a request's own pages, so
# no admission evicts it
POOL_PAGES = 32
PUSH_S = "0.25"


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


def _wait(predicate, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def check_planes(handle):
    """Affinity across processes through the GCS, then the stage
    histograms and the pool gauge read back from it."""
    controller = ray_tpu_torch.get_actor(serve.api.CONTROLLER_NAME)
    _, table = ray_tpu_torch.get(
        controller.get_routing_table.remote("llm"))

    def stats() -> dict:
        return {e["tag"]: ray_tpu_torch.get(e["replica"].handle_request
                                            .remote("stats", (), {}))
                for e in table}

    rng = np.random.default_rng(7)
    prefix = [int(x) for x in rng.integers(1, 200, 2 * PAGE)]
    prompts = [prefix + [int(x) for x in rng.integers(1, 200, 5)]
               for _ in range(AFFINITY_REQUESTS + 1)]
    handle.call(prompts[0], max_new_tokens=NEW_TOKENS,
                _prefix_tokens=prompts[0])
    stats()     # every replica publishes its digest now
    chain = set(digest_hashes(prefix, PAGE))

    def holders():
        tags = [r["payload"]["tag"]
                for r in state.cluster_metric_annexes(DIGEST_PREFIX)
                if chain <= set(r["payload"]["hashes"])]
        return tags if len(tags) == 1 else None

    holder = _wait(holders, 10, "one holder's digest in the GCS")[0]
    # the handle pulls digests at most once an interval: the first
    # request's pull saw no holder yet
    time.sleep(get_config().serve_digest_publish_interval_s)
    other = next(e["tag"] for e in table if e["tag"] != holder)
    before = stats()
    for p in prompts[1:]:
        handle.call(p, max_new_tokens=NEW_TOKENS, _prefix_tokens=p)
    after = stats()
    grew = {t: after[t]["prefix_cache"]["hit_pages"]
            - before[t]["prefix_cache"]["hit_pages"] for t in after}
    assert grew == {holder: 2 * AFFINITY_REQUESTS, other: 0}
    served = {t: after[t]["total_finished"] - before[t]["total_finished"]
              for t in after}
    assert served == {holder: AFFINITY_REQUESTS, other: 0}

    # every request a replica served observed its four stages once
    def stage_counts():
        res = state.cluster_metrics("ray_tpu_serve_stage_s",
                                    tags={"deployment": "llm"},
                                    group_by=("replica", "stage"))
        out = {(g["tags"]["replica"], g["tags"]["stage"]): g["value"]
               for g in res.get("groups", ())}
        total = {t: s["total_finished"] for t, s in after.items()}
        ok = all(out.get((t, st), {}).get("count") == n
                 for t, n in total.items()
                 for st in ("queue_wait", "prefill", "pipeline_stall",
                            "ship"))
        return out if ok else None

    hists = _wait(stage_counts, 20 * float(PUSH_S),
                  "stage counts equal to the requests served")
    for t, s in after.items():
        n = s["total_finished"]
        stage_sum = sum(hists[(t, st)]["sum"] for st in (
            "queue_wait", "prefill", "pipeline_stall", "ship"))
        # the engine's window of TTFTs holds every request here
        assert abs(stage_sum - s["mean_ttft_s"] * n) <= 1e-6 * n
    kv = state.cluster_metrics("ray_tpu_serve_kv_pages",
                               tags={"state": "total"},
                               group_by=("replica",))
    assert {g["tags"]["replica"]: g["value"] for g in kv["groups"]} == \
        {t: s["kv_pages_total"] for t, s in after.items()}


def test_llm_deployment_replicas_in_worker_processes(jax_tokens, tmp_path):
    params, want = jax_tokens
    path = str(tmp_path / "llama_tiny.npz")
    save_npz(jax.tree.map(np.asarray, params), path)
    saved = {k: os.environ.get(k) for k in
             ("OMP_NUM_THREADS", "RAY_TPU_METRICS_PUSH_INTERVAL_S")}
    os.environ["OMP_NUM_THREADS"] = "1"
    # the replicas' pushers (they inherit the flag) ship every 0.25 s
    os.environ["RAY_TPU_METRICS_PUSH_INTERVAL_S"] = PUSH_S
    ray_tpu_torch.shutdown()
    cluster = Cluster()
    try:
        node = cluster.add_node(num_cpus=4)
        ray_tpu_torch.init(address=cluster.gcs_address)
        handle = serve.run(serve.deployment(LLMDeployment, num_replicas=2)
                           .bind(functools.partial(npz_model, path),
                                 max_batch=2, max_len=64, page_size=PAGE,
                                 num_pages=POOL_PAGES, device="cpu"),
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
        check_planes(handle)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + 10
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in pids if alive(p)]
