"""The port's C API (``ray_tpu_torch/csrc/capi/``) against the JAX package's.

The port's copy of ``example_submit`` (built at first use into
``ray_tpu_torch/_build/`` by ``_private/build.py``) runs against a port
cluster, and the JAX package's (compiled here from ``src/capi/`` into a
temporary directory, as its Makefile would) against a JAX cluster: a
put/get round trip, then tasks submitted by function descriptor that
Python workers run (``examples/xlang.py``). Both print the same lines
(the object id aside).
"""

import os
import re
import shutil
import subprocess

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch._private import build
from ray_tpu_torch.cluster_utils import Cluster as TorchCluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(out_dir) -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        pytest.skip("no C++ compiler")
    exe = os.path.join(out_dir, "example_submit")
    src = os.path.join(REPO, "src", "capi")
    subprocess.run([cxx, "-O2", "-std=c++17", "-o", exe,
                    os.path.join(src, "example_submit.cc"),
                    os.path.join(src, "ray_api.cc"), "-lpthread"],
                   check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, cluster_cls) -> str:
    c = cluster_cls()
    try:
        c.add_node(num_cpus=2)
        host, port = c.gcs_address
        proc = subprocess.run([exe, host, str(port)], capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        return re.sub(r'"oid": "[0-9a-f]+"', '"oid": "OID"', proc.stdout)
    finally:
        c.shutdown()


def test_example_submit_prints_what_jax_prints(tmp_path):
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    want = _run(_jax_example(str(tmp_path)), JaxCluster)
    exe = build.capi_example()
    assert exe.parent == build.BUILD_DIR
    got = _run(str(exe), TorchCluster)
    assert got == want
    assert got.splitlines() == ['{"put_get": "ok", "oid": "OID"}',
                                '{"task": "ok", "result": 42}',
                                '{"stats": "ok", "sum": 12.0}']
    # the port's sources name the port's descriptors
    with open(build.CAPI / "example_submit.cc") as f:
        assert "ray_tpu_torch.examples.xlang:add" in f.read()
