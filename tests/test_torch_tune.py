"""The port's Tune library and the serve and data leftovers against the JAX
package, in process, on the CPU (no rank is spawned here; the Tuner's
runs are in ``tests/test_torch_tune_runs.py``).

- Every scheduler of ``ray_tpu_torch/tune/schedulers.py`` takes the same
  decisions as ``ray_tpu/tune/schedulers.py`` on one scripted stream of
  reports (a simulated controller: stopped trials leave, exploited ones
  adopt the explored config and restart their count), and PBT's and
  PB2's ``explore`` give the same configs, bit for bit. Each stream is
  scripted so that every decision the scheduler can take occurs.
- Every searcher of ``tune/search.py`` suggests the same configs as
  JAX's for the same seed and observations, bit for bit.
- Controls: the port on another stream seed (the schedulers) or another
  searcher seed must give another sequence than JAX's.
- ``serve/context.py``'s replica context is per thread and tags an
  engine built under it; ``LLMDeployment`` gives JAX's greedy tokens on
  ``llama_tiny`` (paged and dense) and JAX's ``stats()`` keys;
  ``DataIterator.iter_rows`` yields what JAX's column-dict blocks yield.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu.data.block import BlockAccessor
from ray_tpu.models import llama as jllama
from ray_tpu.serve import context as jcontext
from ray_tpu.serve.llm import LLMDeployment as JaxLLMDeployment
from ray_tpu_torch import convert
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import context as tcontext
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_SEED = 3


# --- schedulers -----------------------------------------------------------


class _Trial:
    def __init__(self, trial_id, config):
        self.trial_id = trial_id
        self.config = config


def _asha(m):
    return m.AsyncHyperBandScheduler(metric="score", mode="max",
                                     grace_period=1, max_t=9,
                                     reduction_factor=2)


def _median(m):
    return m.MedianStoppingRule(metric="loss", mode="min", grace_period=2)


def _hyperband(m):
    return m.HyperBandScheduler(metric="score", mode="max", r=1, eta=2,
                                max_t=8)


def _pbt(m, seed=0):
    return m.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": m.uniform(1e-4, 1e-1),
                              "act": ["relu", "gelu", "silu"]},
        quantile_fraction=0.25, seed=seed, max_exploits_per_trial=2)


def _pb2(m, seed=0):
    return m.PB2(metric="score", mode="max", perturbation_interval=2,
                 hyperparam_bounds={"lr": (1e-4, 1e-1), "x": (0.0, 10.0)},
                 quantile_fraction=0.25, seed=seed, n_candidates=16)


SCHEDULERS = {
    "asha": (_asha, {"CONTINUE", "STOP"}),
    "median_stopping": (_median, {"CONTINUE", "STOP"}),
    "hyperband": (_hyperband, {"CONTINUE", "STOP"}),
    "pbt": (_pbt, {"CONTINUE", "EXPLOIT"}),
    "pb2": (_pb2, {"CONTINUE", "EXPLOIT"}),
}


def _drive(sched, schedulers_mod, stream_seed, n_trials=8, rounds=10):
    """Feed ``sched`` a scripted stream of reports, round-robin over the
    live trials, as the controller does; returns every decision (and each
    exploit's explored config) in order. Trials keep a quality and a noise
    drawn from ``stream_seed``; one trial leaves early (``on_trial_gone``)
    and ``set_population`` names the trials up front."""
    rng = np.random.default_rng(stream_seed)
    trials = [_Trial(f"trial_{i:05d}",
                     {"lr": float(10 ** rng.uniform(-4, -1)),
                      "x": float(rng.uniform(0, 10)), "act": "relu"})
              for i in range(n_trials)]
    quality = {t.trial_id: float(rng.uniform(0.2, 1.0)) for t in trials}
    by_id = {t.trial_id: t for t in trials}
    set_pop = getattr(sched, "set_population", None)
    if set_pop is not None:
        set_pop({t.trial_id for t in trials})
    gone = getattr(sched, "on_trial_gone", None)
    live, count, log = list(trials), {t.trial_id: 0 for t in trials}, []
    for r in range(rounds):
        for t in list(live):
            if r == 3 and t is trials[-1]:
                # a trial that ends outside the scheduler's control
                live.remove(t)
                if gone is not None:
                    gone(t.trial_id)
                log.append((t.trial_id, "gone"))
                continue
            count[t.trial_id] += 1
            it = count[t.trial_id]
            value = quality[t.trial_id] * it + float(rng.normal(0, 0.3))
            result = {"score": value, "loss": 10.0 - value,
                      "training_iteration": it}
            decision = sched.on_result(t, result)
            log.append((t.trial_id, it, decision))
            if decision == schedulers_mod.STOP:
                live.remove(t)
                if gone is not None:
                    gone(t.trial_id)
            elif isinstance(decision, tuple) and decision[0] == "EXPLOIT":
                explored = sched.explore(dict(by_id[decision[1]].config))
                t.config = explored
                quality[t.trial_id] = quality[decision[1]]
                count[t.trial_id] = 0
                log.append((t.trial_id, "explored", explored))
    return log


def _kinds(log) -> set:
    return {e[2] if isinstance(e[2], str) else e[2][0]
            for e in log if len(e) == 3 and e[1] != "explored"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match_jax(name):
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu_torch.tune import schedulers as tsched

    make, kinds = SCHEDULERS[name]
    want = _drive(make(jtune), jsched, STREAM_SEED)
    got = _drive(make(ttune), tsched, STREAM_SEED)
    assert got == want
    assert _kinds(got) == kinds, _kinds(got)
    # control: another stream of reports takes other decisions
    assert _drive(make(ttune), tsched, STREAM_SEED + 1) != want


@pytest.mark.parametrize("name", ["pbt", "pb2"])
def test_population_scheduler_seed_control(name):
    """PBT's donors and explored configs, and PB2's proposals, follow the
    scheduler's seed: the port at another seed leaves JAX's sequence."""
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu_torch.tune import schedulers as tsched

    make = SCHEDULERS[name][0]
    want = _drive(make(jtune, seed=0), jsched, STREAM_SEED)
    assert _drive(make(ttune, seed=0), tsched, STREAM_SEED) == want
    assert _drive(make(ttune, seed=1), tsched, STREAM_SEED) != want


# --- searchers ------------------------------------------------------------


def _variant_space(m):
    return {"lr": m.loguniform(1e-5, 1e-1), "wd": m.uniform(0.0, 0.3),
            "layers": m.randint(1, 9), "act": m.choice(["relu", "gelu"]),
            "opt": {"b1": m.uniform(0.8, 0.99),
                    "sched": m.grid_search(["cosine", "linear"])},
            "batch": m.grid_search([16, 32, 64]), "fixed": 7}


def _flat_space(m):
    return {"x": m.uniform(-10.0, 10.0), "n": m.randint(0, 20),
            "lr": m.loguniform(1e-4, 1e-1),
            "act": m.choice(["relu", "gelu", "silu"]), "fixed": 3}


def _int_space(m):
    return {"n": m.randint(0, 50), "m": m.randint(-5, 5),
            "x": m.uniform(0.0, 1.0)}


def _objective(cfg: dict) -> float:
    score = -(cfg["x"] - 3.0) ** 2 if "x" in cfg else 0.0
    score -= 0.1 * abs(cfg.get("n", 0) - 7)
    if "m" in cfg:
        score -= abs(cfg["m"])
    return score + {"relu": 0.0, "gelu": 0.5, "silu": 0.2}.get(
        cfg.get("act"), 0.0)


def _search(searcher, n: int, budgets=(1,)) -> list:
    """Suggest ``n`` configs one after another, feeding each trial's
    scores at ``budgets`` (``on_trial_result``) and its last at
    completion; a ``None`` suggestion is recorded and skipped."""
    out = []
    for i in range(n):
        tid = f"trial_{i:05d}"
        cfg = searcher.suggest(tid)
        out.append(cfg)
        if cfg is None:
            continue
        result = {}
        for b in budgets:
            result = {"score": _objective(cfg) * b / budgets[-1],
                      "training_iteration": b}
            searcher.on_trial_result(tid, result)
        searcher.on_trial_complete(tid, result)
    return out


SEARCHERS = {
    "basic_variant": lambda m, seed: m.BasicVariantGenerator(
        _variant_space(m), num_samples=3, seed=seed),
    "tpe": lambda m, seed: m.TPESearcher(
        _flat_space(m), metric="score", mode="max", num_samples=16,
        n_startup=4, seed=seed),
    "bohb": lambda m, seed: m.BOHBSearcher(
        _flat_space(m), metric="score", mode="max", num_samples=14,
        n_startup=3, seed=seed),
    "bayesopt_int": lambda m, seed: m.BayesOptSearcher(
        _int_space(m), metric="score", mode="max", num_samples=12,
        n_startup=4, n_candidates=64, seed=seed),
}


def _suggestions(name, m, seed):
    searcher = SEARCHERS[name](m, seed)
    if name == "basic_variant":
        return searcher.variants()
    return _search(searcher, 18, budgets=(1, 2, 3) if name == "bohb"
                   else (1,))


@pytest.mark.parametrize("name", sorted(SEARCHERS))
def test_searcher_suggestions_match_jax(name):
    want = _suggestions(name, jtune, 5)
    got = _suggestions(name, ttune, 5)
    assert got == want
    assert len([c for c in got if c is not None]) >= 12
    if name == "bayesopt_int":
        # the GP's proposals keep the integer domains' type and bounds
        assert all(isinstance(c["n"], int) and 0 <= c["n"] < 50
                   and isinstance(c["m"], int) and -5 <= c["m"] < 5
                   for c in got[4:] if c is not None)
    # control: another seed suggests other configs
    assert _suggestions(name, ttune, 6) != want


def _limited(m, seed):
    lim = m.ConcurrencyLimiter(m.TPESearcher(
        _flat_space(m), metric="score", mode="max", num_samples=10,
        n_startup=2, seed=seed), max_concurrent=2)
    out, live = [], []
    for i in range(24):
        tid = f"trial_{i:05d}"
        cfg = lim.suggest(tid)
        out.append(cfg)
        if cfg is not None:
            live.append((tid, cfg))
        if live and (cfg is None or i % 3 == 2):
            # the cap refused (or every third call): finish the oldest
            done, dcfg = live.pop(0)
            lim.on_trial_complete(done, {"score": _objective(dcfg)})
    return out


def test_concurrency_limiter_matches_jax():
    want = _limited(jtune, 2)
    got = _limited(ttune, 2)
    assert got == want
    assert None in got and sum(c is not None for c in got) == 10
    assert _limited(ttune, 3) != want


# --- serve: replica context and LLMDeployment -----------------------------


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
    return jcfg, jparams, tcfg, tparams


def _replica(ctx_mod, deployment, tag, out: dict, key: str):
    ctx_mod.set_replica_context(deployment, tag)
    out[key] = ctx_mod.get_replica_context()


@pytest.mark.parametrize("mod", [jcontext, tcontext], ids=["jax", "torch"])
def test_replica_context_is_per_thread(mod):
    seen = {}
    try:
        mod.set_replica_context("main-dep", "main#0")
        t = threading.Thread(target=_replica,
                             args=(mod, "llm", "llm#3", seen, "thread"))
        t.start()
        t.join(10)
        assert not t.is_alive()
        seen["main"] = mod.get_replica_context()
        mod.set_replica_context(None, "x")
        seen["cleared"] = mod.get_replica_context()
    finally:
        mod.set_replica_context(None, None)
    assert seen["thread"] == mod.ReplicaContext("llm", "llm#3")
    assert seen["main"] == mod.ReplicaContext("main-dep", "main#0")
    assert seen["cleared"] is None


def test_engine_carries_the_replica_context(tiny):
    *_, tcfg, tparams = tiny
    tcontext.set_replica_context("llama", "llama#1")
    try:
        tagged = LLMEngine(tcfg, tparams, max_batch=2, max_len=64,
                           device="cpu")
    finally:
        tcontext.set_replica_context(None, None)
    plain = LLMEngine(tcfg, tparams, max_batch=2, max_len=64, device="cpu")
    assert (tagged.deployment_name, tagged.replica_tag) == ("llama",
                                                           "llama#1")
    assert plain.deployment_name == "-"
    assert plain.replica_tag.startswith("engine-")


PROMPTS = [np.random.default_rng(i).integers(1, 512, n)
           for i, n in enumerate((24, 48, 13))]


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_llm_deployment_matches_jax(tiny, kv_layout):
    jcfg, jparams, tcfg, tparams = tiny
    kw = {"page_size": 16} if kv_layout == "paged" else {}
    jdep = JaxLLMDeployment(lambda: (jcfg, jparams), max_batch=4,
                            max_len=128, kv_layout=kv_layout, **kw)
    tdep = LLMDeployment(lambda: (tcfg, tparams), max_batch=4, max_len=128,
                         kv_layout=kv_layout, device="cpu", **kw)
    try:
        want = [jdep(p, max_new_tokens=12) for p in PROMPTS]
        got = [tdep(p, max_new_tokens=12) for p in PROMPTS]
        jstats, tstats = jdep.stats(), tdep.stats()
    finally:
        jdep._engine.stop()
        tdep._engine.stop()
    assert got == want
    assert all(len(t) == 12 for t in got)
    assert sorted(tstats) == sorted(jstats)
    assert tstats["total_finished"] == jstats["total_finished"] == 3
    assert tstats["total_generated"] == jstats["total_generated"] == 36


def test_llm_deployment_refuses_an_unknown_layout(tiny):
    *_, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="kv_layout"):
        LLMDeployment(lambda: (tcfg, tparams), kv_layout="ring",
                      device="cpu")


# --- data: iter_rows ------------------------------------------------------


def test_iter_rows_matches_jax_blocks():
    rng = np.random.default_rng(0)
    blocks = [{"id": np.arange(5), "x": rng.normal(size=(5, 3)),
               "tag": np.array(list("abcde"))},
              {"id": np.arange(0), "x": np.zeros((0, 3)),
               "tag": np.array([], dtype="<U1")},
              {"id": np.arange(5, 8), "x": rng.normal(size=(3, 3)),
               "tag": np.array(list("fgh"))}]
    want = [r for b in blocks for r in BlockAccessor.for_block(b).iter_rows()]
    got = list(DataIterator(blocks).iter_rows())
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert type(g[k]) is type(w[k])
            np.testing.assert_array_equal(g[k], w[k])
    # the iterator reads its blocks anew each time
    assert [int(r["id"]) for r in DataIterator(blocks).iter_rows()] == \
        list(range(8))


# --- import hygiene -------------------------------------------------------

TUNE_PROBE = r"""
import json, sys
import ray_tpu_torch.tune
import torch
print(json.dumps({
    "all": sorted(ray_tpu_torch.tune.__all__),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_fresh_tune_import_loads_no_jax_no_ray_tpu_no_cuda():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", TUNE_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["all"] == sorted(jtune.__all__)
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cuda_initialized"] is False


# --- the quickstarts ------------------------------------------------------


@pytest.fixture
def one_thread():
    """torch on one thread: the quickstart's mesh runs many tiny ops,
    whose thread pools spin for minutes when the host's cores are busy
    (the suite runs on several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_llama_quickstart_losses_fall(one_thread):
    from ray_tpu_torch.examples import train_llama

    assert train_llama.mesh_axes(4) == {"dp": 1, "fsdp": 2, "tp": 2}
    assert train_llama.mesh_axes(6) == {"dp": 3, "fsdp": 1, "tp": 2}
    history = train_llama.main(device="cpu")
    losses = [h["loss"] for h in history]
    assert [h["step"] for h in history] == [10.0, 20.0, 30.0]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_llm_serving_quickstart_hits_the_prefix_cache(one_thread):
    from ray_tpu_torch.examples import llm_serving

    before = threading.active_count()
    out = llm_serving.main(device="cpu")
    assert out["prefix_cache"]["hit_pages"] >= 2
    assert [len(t) for t in out["tokens"]] == [12] * 4
    assert all(0 <= t < 512 for toks in out["tokens"] for t in toks)
    # the engine was stopped: no loop thread is left behind
    assert threading.active_count() <= before
