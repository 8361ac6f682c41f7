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


def test_fresh_import_loads_no_jax_no_ray_tpu_no_cuda():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"ray_tpu_torch." + m.name for m in pkgutil.walk_packages(
        ray_tpu_torch.__path__)}
    assert expected <= set(out["modules"])
    assert "ray_tpu_torch.serve.paged_llm" in out["modules"]
    for name in ("train.trainer", "train.state", "train.checkpoint",
                 "train.optim", "train.spmd", "ops.moe", "ops.matmul",
                 "models.mixtral", "models.gpt", "models.bert", "models.vit",
                 "parallel.pipeline", "parallel.sharding",
                 "parallel.process_group", "air.config", "data.iterator",
                 "train.telemetry", "train.session", "train.worker_group",
                 "train.data_parallel_trainer", "train.elastic"):
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
