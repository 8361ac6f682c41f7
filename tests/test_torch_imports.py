"""Import hygiene of the PyTorch port, checked in a fresh interpreter.

Every module of ray_tpu_torch imports without pulling in jax or any
module of ray_tpu, and without starting CUDA (a CUDA context made at
import time would be inherited by forked workers).
"""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    ray_tpu_torch.__path__, "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (the module only; main() is not run)
import torch
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    return env


# ray_tpu_torch.util and .experimental, and the host collectives' binding
SLICE21_MODULES = ("util", "util.actor_pool", "util.queue", "util.iter",
                   "util.multiprocessing", "util.placement_group",
                   "util.accelerators", "util.collective",
                   "util.joblib_backend", "util.dask", "util.spark",
                   "experimental", "experimental.internal_kv",
                   "experimental.free", "experimental.tqdm_ray",
                   "_private.tcp_collective")


def test_fresh_import_loads_no_jax_no_ray_tpu_no_cuda():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # walked with the package's prefix: a bare walk would import each
    # subpackage by its short name (``examples``, ``tune``), which may name
    # another installed package
    expected = {m.name for m in pkgutil.walk_packages(
        ray_tpu_torch.__path__, "ray_tpu_torch.")}
    assert expected <= set(out["modules"])
    assert "ray_tpu_torch.serve.paged_llm" in out["modules"]
    for name in ("train.trainer", "train.state", "train.checkpoint",
                 "train.optim", "train.spmd", "ops.moe", "ops.matmul",
                 "models.mixtral", "models.gpt", "models.bert", "models.vit",
                 "parallel.pipeline", "parallel.sharding",
                 "parallel.process_group", "air.config", "data.iterator",
                 "train.telemetry", "train.session", "train.worker_group",
                 "train.data_parallel_trainer", "train.elastic",
                 "rllib", "rllib.env", "rllib.gym_env", "rllib.ppo",
                 "rllib.pg", "rllib.impala", "rllib.appo",
                 "rllib.learner_group", "rllib.dqn", "rllib.replay",
                 "rllib.sac", "rllib.td3", "rllib.offline",
                 "rllib.estimators", "rllib.marwil", "rllib.recurrent",
                 "rllib.multi_agent", "rllib.dreamer", "rllib.bandit",
                 "rllib.es", "rllib.connectors", "examples.rllib_quickstart",
                 "tune", "tune.tuner",
                 "tune.schedulers", "tune.search", "examples.train_llama",
                 "examples.llm_serving", "examples.tune_llama", "api",
                 "runtime_context", "runtime.core", "runtime.task_spec",
                 "runtime.refcount", "runtime.object_ref",
                 "runtime.object_store", "runtime.streaming",
                 "runtime.annex", "utils.ids", "utils.exceptions",
                 "serve.config", "serve.multiplex", "serve.prefix_router",
                 "serve.controller", "serve.handle", "serve.api",
                 "examples.serve_quickstart", "serve.schema",
                 "serve.ingress", "scripts.cli", "runtime.prestart",
                 "runtime.fault_injection", "runtime_env", "chaos_soak",
                 "examples.xlang", "data.dataset", "data.execution",
                 "data.block", "data.context", "data.stats",
                 "data.aggregate", "data.grouped", "data.preprocessors",
                 "data.tfrecord", "data.avro", "data.sql", "data.mongo",
                 "dag", "workflow", "_private.usage_stats",
                 "examples.data_pipeline", *SLICE21_MODULES):
        assert f"ray_tpu_torch.{name}" in out["modules"]
    assert out["jax"] == []
    assert out["ray_tpu"] == []
    assert out["cuda_initialized"] is False


def test_chip_smoke_refuses_without_a_card():
    """With no card, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


SEQUENCE_PARALLEL_PROBE = r"""
import importlib, json, sys
names = ["ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.collectives",
         "ray_tpu_torch.parallel.sharding",
         "ray_tpu_torch.parallel.ring_attention",
         "ray_tpu_torch.parallel.ulysses",
         "ray_tpu_torch.models.speculative"]
for name in names:
    importlib.import_module(name)
import torch
print(json.dumps({
    "loaded": [n for n in names if n in sys.modules],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_sequence_parallel_and_speculative_modules_load_alone():
    """A fresh import of the parallel modules and of speculative decoding,
    with nothing else imported first, loads no jax, no ray_tpu module and
    no CUDA."""
    proc = subprocess.run([sys.executable, "-c", SEQUENCE_PARALLEL_PROBE],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["loaded"]) == 6
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cuda_initialized"] is False


PLACEMENT_PROBE = r"""
import importlib, json, sys
names = ["ray_tpu_torch.parallel.sharding", "ray_tpu_torch.parallel.pipeline",
         "ray_tpu_torch.train.spmd", "ray_tpu_torch.train.state",
         "ray_tpu_torch.train.checkpoint", "ray_tpu_torch.train.trainer"]
for name in names:
    importlib.import_module(name)
import torch
print(json.dumps({
    "loaded": [n for n in names if n in sys.modules],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_placement_and_pipeline_modules_load_alone():
    """A fresh import of the placement, the pipeline, the per-rank step
    and the trainer, with nothing else imported first, loads no jax, no
    ray_tpu module and no CUDA."""
    proc = subprocess.run([sys.executable, "-c", PLACEMENT_PROBE],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["loaded"]) == 6
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cuda_initialized"] is False


HARNESS_PROBE = r"""
import importlib, json, sys, tempfile
names = ["ray_tpu_torch.air.config", "ray_tpu_torch.train.telemetry",
         "ray_tpu_torch.train.session",
         "ray_tpu_torch.parallel.process_group",
         "ray_tpu_torch.train.worker_group",
         "ray_tpu_torch.train.data_parallel_trainer",
         "ray_tpu_torch.data.iterator", "ray_tpu_torch.train.elastic"]
for name in names:
    importlib.import_module(name)
import torch
here = {
    "loaded": [n for n in names if n in sys.modules],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}
sys.path.insert(0, "tests")
from torch_harness_loops import modules_loop
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
with tempfile.TemporaryDirectory() as d:
    result = DataParallelTrainer(
        modules_loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=d)).fit()
print(json.dumps({**here, "rank": result.metrics, "error": result.error}))
"""


def test_harness_modules_and_a_spawned_rank_load_no_jax():
    """A fresh import of the harness modules loads no jax, no ray_tpu
    module and no CUDA; neither does a rank process that they spawn and
    that builds the trainer."""
    proc = subprocess.run([sys.executable, "-c", HARNESS_PROBE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["loaded"]) == 8
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cuda_initialized"] is False
    assert out["error"] is None
    assert out["rank"] == {"jax": [], "ray_tpu": [],
                           "cuda_initialized": False}


RLLIB_PROBE = r"""
import json, sys
import ray_tpu_torch.rllib
import torch
print(json.dumps({
    "loaded": sorted(m for m in sys.modules
                     if m.startswith("ray_tpu_torch.rllib.")),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cloudpickle": sorted(m for m in sys.modules
                          if m.split(".")[0] == "cloudpickle"),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_rllib_loads_no_jax_no_ray_tpu_no_cloudpickle_no_cuda():
    """A fresh ``import ray_tpu_torch.rllib``, nothing imported first,
    loads every RLlib module of the port and no jax, no ray_tpu module, no
    cloudpickle (the card's machine has none: the multi-agent mapping
    reaches the in-process workers as it is) and no CUDA."""
    proc = subprocess.run([sys.executable, "-c", RLLIB_PROBE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("recurrent", "multi_agent", "dreamer", "bandit", "es",
                 "connectors", "impala", "ppo"):
        assert f"ray_tpu_torch.rllib.{name}" in out["loaded"]
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cloudpickle"] == []
    assert out["cuda_initialized"] is False


def test_rllib_exports_every_name_of_the_jax_package():
    """``ray_tpu_torch.rllib`` exports the names ``ray_tpu.rllib`` imports
    (its public attributes other than modules), and its ``__all__`` is
    exactly those."""
    import inspect

    import ray_tpu.rllib as jax_rllib

    import ray_tpu_torch.rllib as port_rllib

    def names(mod) -> set:
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not inspect.ismodule(v)}

    want = names(jax_rllib)
    assert {"ConnectorEnv", "MultiAgentReplay", "PolicyMap", "MemoryCueEnv",
            "StatelessCartPole", "DreamerV3", "ES", "BanditLinTS"} <= want
    assert names(port_rllib) == want
    assert set(port_rllib.__all__) == want


TRAIN_PROBE = r"""
import json, sys
from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig, report, Trainer
import torch
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""

# ray_tpu.train's names for integrations of other frameworks, which the
# port does not carry (no device plane of their own), and its renames
TRAIN_NOT_PORTED = {"AccelerateTrainer", "GBTModel", "LightGBMTrainer",
                    "LightningTrainer", "TorchConfig", "TorchTrainer",
                    "TransformersTrainer", "XGBoostTrainer"}
TRAIN_RENAMES = {"JaxTrainer": "Trainer", "JaxMeshTrainer": "TorchMeshTrainer"}


def test_train_air_data_export_the_jax_packages_names():
    """``ray_tpu_torch.train`` exports every device-plane name that
    ``ray_tpu.train`` exports (``JaxTrainer`` as ``Trainer``,
    ``JaxMeshTrainer`` as ``TorchMeshTrainer``), ``ray_tpu_torch.air``
    its four configs, ``ray_tpu_torch.data`` every name of
    ``ray_tpu.data`` (since the port's ``Dataset``), and
    ``train.telemetry`` JAX's ``STEP_STAGES``; each package's
    ``__all__`` is exactly those. A fresh ``from ray_tpu_torch.train
    import ...`` loads no jax, no ray_tpu module and no CUDA."""
    import ray_tpu.air as jax_air
    import ray_tpu.data as jax_data
    import ray_tpu.train as jax_train
    import ray_tpu.train.telemetry as jax_telemetry

    import ray_tpu_torch.air as port_air
    import ray_tpu_torch.data as port_data
    import ray_tpu_torch.train as port_train
    from ray_tpu_torch.train import telemetry

    want = {TRAIN_RENAMES.get(n, n) for n in jax_train.__all__} - \
        TRAIN_NOT_PORTED
    assert {"Trainer", "TorchMeshTrainer", "DataParallelTrainer",
            "ScalingConfig", "report", "ElasticTrainer"} <= want
    assert set(port_train.__all__) == want
    assert all(hasattr(port_train, n) for n in want)
    assert set(port_air.__all__) == set(jax_air.__all__)
    assert all(hasattr(port_air, n) for n in jax_air.__all__)
    assert set(port_data.__all__) == set(jax_data.__all__)
    assert all(hasattr(port_data, n) for n in jax_data.__all__)
    assert telemetry.STEP_STAGES == jax_telemetry.STEP_STAGES
    proc = subprocess.run([sys.executable, "-c", TRAIN_PROBE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"jax": [], "ray_tpu": [], "cuda_initialized": False}


CORE_SERVE_PROBE = r"""
import json, sys
import ray_tpu_torch, ray_tpu_torch.api, ray_tpu_torch.serve
import torch


def loaded(name):
    return sorted(m for m in sys.modules
                  if m == name or m.startswith(name + "."))


print(json.dumps({
    "jax": loaded("jax"), "ray_tpu": loaded("ray_tpu"),
    "cloudpickle": loaded("cloudpickle"), "yaml": loaded("yaml"),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""

# ray_tpu.serve's names that wait for their slices: none since
# serve/ingress.py and serve/schema.py were ported
SERVE_WAITING: set = set()
# ray_tpu's names that wait for their planes: the task timeline
# (observability)
CORE_WAITING = {"timeline"}


def test_core_api_and_serve_load_no_jax_cloudpickle_yaml_or_cuda():
    """A fresh ``import ray_tpu_torch`` (with ``.api`` and ``.serve``)
    loads no jax, no ray_tpu module, no cloudpickle, no yaml (the card's
    machine has neither) and no CUDA."""
    proc = subprocess.run([sys.executable, "-c", CORE_SERVE_PROBE],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"jax": [], "ray_tpu": [], "cloudpickle": [], "yaml": [],
                   "cuda_initialized": False}


def test_core_api_and_serve_export_the_jax_packages_names():
    """``ray_tpu_torch`` exports ``ray_tpu``'s core API, and
    ``ray_tpu_torch.serve`` exports ``ray_tpu.serve``'s names, but for
    those listed as waiting; each ``__all__`` is exactly those."""
    import ray_tpu
    import ray_tpu.serve as jax_serve

    import ray_tpu_torch
    import ray_tpu_torch.serve as port_serve

    want = set(ray_tpu.__all__) - CORE_WAITING
    assert {"init", "remote", "get", "put", "wait", "kill", "get_actor",
            "ObjectRef", "ObjectRefGenerator"} <= want
    assert set(ray_tpu_torch.__all__) == want
    assert all(hasattr(ray_tpu_torch, n) for n in want)
    want = set(jax_serve.__all__) - SERVE_WAITING
    assert {"run", "deployment", "start_http_proxy", "batch"} <= want
    assert set(port_serve.__all__) == want
    assert all(hasattr(port_serve, n) for n in want)


CLUSTER_PROBE = r"""
import json, os, sys


def loaded(name):
    return sorted(m for m in sys.modules
                  if m == name or m.startswith(name + "."))


def report():
    import torch

    return {"jax": loaded("jax"), "ray_tpu": loaded("ray_tpu"),
            "cloudpickle": loaded("cloudpickle"), "grpc": loaded("grpc"),
            "yaml": loaded("yaml"),
            "cuda_initialized": torch.cuda.is_initialized(),
            "pid": os.getpid()}


if __name__ == "__main__":
    import ray_tpu_torch.cluster_utils
    import ray_tpu_torch.runtime.driver
    import ray_tpu_torch.runtime.gcs
    import ray_tpu_torch.runtime.raylet
    import ray_tpu_torch.runtime.worker_main
    from ray_tpu_torch._private import build, scheduling, shm_store

    built = sorted(os.listdir(build.BUILD_DIR)) \
        if build.BUILD_DIR.exists() else []
    imported = {**report(), "store_loaded": shm_store._lib is not None,
                "scheduling_loaded": scheduling._lib is not None,
                "built_after_import": built == sys.argv[1:]}
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster()
    c.add_node(num_cpus=1)
    ray_tpu_torch.init(address=c.gcs_address)
    try:
        worker = ray_tpu_torch.get(ray_tpu_torch.remote(report).remote())
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    print(json.dumps({"import": imported, "worker": worker,
                      "driver_pid": os.getpid()}))
"""


def test_cluster_modules_and_a_worker_load_no_jax_cloudpickle_or_cuda(
        tmp_path):
    """Importing ``cluster_utils`` and the cluster runtime's modules loads
    no jax, no ray_tpu module, no cloudpickle, grpc or yaml and no CUDA,
    and builds or loads no library; a task in a port worker process
    reports the same of its own modules."""
    from ray_tpu_torch._private import build

    script = tmp_path / "cluster_probe.py"
    script.write_text(CLUSTER_PROBE)
    before = sorted(os.listdir(build.BUILD_DIR)) \
        if build.BUILD_DIR.exists() else []
    proc = subprocess.run([sys.executable, str(script), *before],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    clean = {"jax": [], "ray_tpu": [], "cloudpickle": [], "grpc": [],
             "yaml": [], "cuda_initialized": False}
    imported = out["import"]
    assert {k: imported[k] for k in clean} == clean
    assert not imported["store_loaded"] and not imported["scheduling_loaded"]
    assert imported["built_after_import"]
    worker = out["worker"]
    assert {k: worker[k] for k in clean} == clean
    assert worker["pid"] != out["driver_pid"]


SLICE19_PROBE = r"""
import importlib, json, sys
names = ["ray_tpu_torch.serve.schema", "ray_tpu_torch.serve.ingress",
         "ray_tpu_torch.scripts.cli", "ray_tpu_torch.runtime.prestart",
         "ray_tpu_torch.runtime.fault_injection", "ray_tpu_torch.runtime_env",
         "ray_tpu_torch.chaos_soak"]
for name in names:
    importlib.import_module(name)
from ray_tpu_torch.runtime.prestart import libcuda_mapped
import torch
print(json.dumps({
    "loaded": [n for n in names if n in sys.modules],
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "ray_tpu": sorted(m for m in sys.modules
                      if m == "ray_tpu" or m.startswith("ray_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "libcuda_mapped": libcuda_mapped(),
}))
"""


def test_ingress_cli_prestart_fault_env_soak_modules_load_alone():
    """A fresh import of the Serve ingress and schema, the CLI, the
    prestart fork server, the fault plane, runtime environments and the
    chaos soak loads no jax, no ray_tpu module and no CUDA (neither
    ``torch.cuda`` initialized nor the driver's libcuda mapped, which a
    forked worker could not survive); ``ray_tpu_torch.serve`` exports
    every name of ``ray_tpu.serve``."""
    proc = subprocess.run([sys.executable, "-c", SLICE19_PROBE],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["loaded"]) == 7
    assert out["jax"] == [] and out["ray_tpu"] == []
    assert out["cuda_initialized"] is False
    if not torch.cuda.is_available():
        # with a card, importing torch maps libcuda (the reason the
        # prestart template never imports torch)
        assert out["libcuda_mapped"] is False
    import ray_tpu.serve as jserve
    import ray_tpu_torch.serve as tserve

    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in jserve.__all__:
        assert hasattr(tserve, name), name


DATA_MODULES = ["ray_tpu_torch.data", "ray_tpu_torch.data.block",
                "ray_tpu_torch.data.context", "ray_tpu_torch.data.stats",
                "ray_tpu_torch.data.execution",
                "ray_tpu_torch.data.aggregate", "ray_tpu_torch.data.grouped",
                "ray_tpu_torch.data.dataset", "ray_tpu_torch.data.iterator",
                "ray_tpu_torch.data.preprocessors",
                "ray_tpu_torch.data.tfrecord", "ray_tpu_torch.data.avro",
                "ray_tpu_torch.data.sql", "ray_tpu_torch.data.mongo",
                "ray_tpu_torch.dag", "ray_tpu_torch.workflow",
                "ray_tpu_torch._private.usage_stats",
                "ray_tpu_torch.examples.data_pipeline"]

# the optional packages hidden: a None in sys.modules makes their import
# raise, so a module that imported one at its top would fail to load
DATA_PROBE = r"""
import importlib, json, sys
HIDDEN = ("jax", "ray_tpu", "pyarrow", "pandas", "PIL")
for name in HIDDEN:
    sys.modules[name] = None
importlib.import_module(sys.argv[1])


def loaded(name):
    return sorted(m for m in sys.modules if (m == name or m.startswith(
        name + ".")) and sys.modules[m] is not None)


print(json.dumps({"hidden": {n: loaded(n) for n in HIDDEN},
                  "torch": "torch" in sys.modules}))
"""


def test_data_dag_workflow_modules_load_alone():
    """Each module of ``data``, ``dag`` and ``workflow`` (with
    ``usage_stats`` and the data quickstart) imports in a fresh
    interpreter of its own with jax, ray_tpu, pyarrow, pandas and PIL
    hidden, and loads none of them; ``data``'s modules load no torch
    either (a cold cluster worker running a map task imports them);
    ``dag`` and ``workflow`` export JAX's names."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", DATA_PROBE, name], cwd=REPO,
        env=_clean_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in DATA_MODULES}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err[-2000:])
        got = json.loads(out.strip().splitlines()[-1])
        assert all(v == [] for v in got["hidden"].values()), (name, got)
        if name.startswith("ray_tpu_torch.data"):
            assert got["torch"] is False, name
    import ray_tpu.dag as jax_dag
    import ray_tpu.workflow as jax_workflow

    import ray_tpu_torch.dag as port_dag
    import ray_tpu_torch.workflow as port_workflow

    for jmod, pmod in ((jax_dag, port_dag), (jax_workflow, port_workflow)):
        names = [n for n, v in vars(jmod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == jmod.__name__]
        assert names and all(hasattr(pmod, n) for n in names), names


SLICE21_PROBE = r"""
import importlib, json, os, sys
HIDDEN = ("jax", "ray_tpu", "joblib", "dask", "pyspark")
for name in HIDDEN:
    sys.modules[name] = None
from ray_tpu_torch._private import build
before = sorted(os.listdir(build.BUILD_DIR)) if build.BUILD_DIR.exists() \
    else []
import ray_tpu_torch.util
util_loaded = sorted(m for m in sys.modules
                     if m.startswith("ray_tpu_torch.util."))
for name in sys.argv[1:]:
    importlib.import_module("ray_tpu_torch." + name)
from ray_tpu_torch._private import tcp_collective
from ray_tpu_torch.data import tfrecord
import torch
after = sorted(os.listdir(build.BUILD_DIR)) if build.BUILD_DIR.exists() \
    else []
print(json.dumps({
    "hidden": {n: sorted(m for m in sys.modules if (m == n or m.startswith(
        n + ".")) and sys.modules[m] is not None) for n in HIDDEN},
    "util_loaded": util_loaded,
    "libraries_loaded": [tcp_collective._lib is not None,
                         tfrecord._crc_lib is not None],
    "built": after != before,
    "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_util_and_experimental_load_alone_and_build_nothing():
    """Every module of ``util`` and ``experimental`` imports in a fresh
    interpreter with jax, ray_tpu, joblib, dask and pyspark hidden, loads
    none of them, builds and loads no host library (the TCP ring and the
    CRC32C build at first use), and initializes no CUDA; ``util``'s
    package, imported first, loads none of its modules (PEP 562
    exports)."""
    names = [n for n in SLICE21_MODULES if n != "util"]
    proc = subprocess.run([sys.executable, "-c", SLICE21_PROBE, *names],
                          cwd=REPO, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(v == [] for v in got["hidden"].values()), got
    assert got["libraries_loaded"] == [False, False]
    assert got["built"] is False and got["cuda_initialized"] is False
    assert got["util_loaded"] == []
