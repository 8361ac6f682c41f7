"""The port's CRC32C (its copy of the C++ library, ``csrc/host/crc32c.cc``,
built by ``_private/build.py``) on the CPU: equal to its plain version,
the Python loop of ``data/tfrecord.py``, and to the JAX package's
``_crc32c`` on random bytes of every length from 0 to 4097; and a
TFRecord file written by one package reads back in the other.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.data import tfrecord as jtf
from ray_tpu_torch._private import build
from ray_tpu_torch.data import tfrecord as ttf


def test_library_equals_the_python_loop_and_jax():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4097 + 64, dtype=np.uint8).tobytes()
    got, plain, jax = [], [], []
    for n in range(4098):
        chunk = data[n % 64:n % 64 + n]   # unaligned starts too
        got.append(ttf._crc32c(chunk))
        plain.append(ttf._crc32c_py(chunk))
        jax.append(jtf._crc32c(chunk))
    assert got == plain == jax
    assert ttf._crc32c(b"123456789") == 0xE3069283   # Castagnoli check
    # the port's own library, built under its _build/
    assert ttf._crc_lib._name == str(build.lib_path("crc32c"))
    assert build.SOURCES["crc32c"] == (["-msse4.2"], [])


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=2, num_tpus=0)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def test_tfrecord_files_cross_read(runtimes, tmp_path):
    """Records of a few hundred kB (the checksum over each whole payload):
    each package's file is the other's byte for byte and reads back in
    it; a flipped byte deep in a payload fails the port's check."""
    from ray_tpu import data as jdata
    from ray_tpu_torch import data as tdata

    rng = np.random.default_rng(1)
    rows = [{"label": i, "blob": rng.integers(0, 256, 100_000 * (i + 1),
                                              dtype=np.uint8).tobytes(),
             "scores": [0.5 * i, -1.0]} for i in range(3)]
    paths = {}
    for d, name in ((jdata, "jax"), (tdata, "torch")):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        d.write_tfrecords_file(rows, paths[name])
    raw = open(paths["jax"], "rb").read()
    assert raw == open(paths["torch"], "rb").read()
    for d, other in ((jdata, "torch"), (tdata, "jax")):
        got = d.read_tfrecords(paths[other]).take_all()
        assert [(r["label"], r["blob"]) for r in got] == \
            [(r["label"], r["blob"]) for r in rows]
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        list(ttf.iter_records(bytes(bad)))
