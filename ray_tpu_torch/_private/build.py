"""Build the port's host-side C++ libraries and its C API's example.

Each source in ``csrc/host/`` (``shm_store.cc``: the shared-memory object
store; ``scheduling.cc``: the hybrid scheduling policy;
``tcp_collective.cc``: the host collectives over TCP; ``crc32c.cc``:
TFRecord's checksum) compiles with the host compiler (``$CXX``, else
``g++``) and flags of its own into its own shared library, loaded with
``ctypes``. The C API in ``csrc/capi/`` (``ray_api.cc``, a framed
msgpack client of the cluster) links into the ``example_submit``
program (``capi_example()``). Each is built at first use into ``_build/``
beside the package, named by a hash of its sources and flags, so an
edited source rebuilds and an unchanged one loads at once. As in ``_kernels.py``, each
build writes a per-process temporary file and renames it into place, so
processes that build the same library at once never load a torn file.

Nothing here runs at import time; a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
CAPI = Path(__file__).resolve().parent.parent / "csrc" / "capi"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
# source name -> (its own compile flags, the libraries it links);
# CRC32C's hardware path is the SSE4.2 instruction
SOURCES = {
    "shm_store": ([], ["-lpthread", "-lrt"]),
    "scheduling": ([], []),
    "tcp_collective": ([], ["-lpthread"]),
    "crc32c": (["-msse4.2"], []),
}

_lock = threading.Lock()


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH "
                           "to build the port's host libraries")
    return cxx


def source(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown host source {name!r}")
    return CSRC / f"{name}.cc"


def lib_path(name: str) -> Path:
    """``_build/lib<name>-<hash>.so``, the hash over the source and the
    flags."""
    flags, libs = SOURCES[name]
    h = hashlib.sha256(source(name).read_bytes())
    h.update(" ".join(CXX_FLAGS + flags + libs).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The library of source ``name``, compiled first if it is not built
    yet."""
    flags, libs = SOURCES[name]
    return _compile(lib_path(name), CXX_FLAGS + flags, [source(name)], libs)


# the C API example: its sources, and the flags of a program (not -shared)
CAPI_SOURCES = ("example_submit.cc", "ray_api.cc")
CAPI_FLAGS = ["-O2", "-std=c++17"]


def capi_example() -> Path:
    """The C API's ``example_submit`` program (``csrc/capi/``), compiled
    first if it is not built yet. Run it as ``example_submit <gcs_host>
    <gcs_port>`` against a running cluster."""
    h = hashlib.sha256()
    for name in (*CAPI_SOURCES, "ray_api.hpp", "msgpack_lite.hpp"):
        h.update((CAPI / name).read_bytes())
    h.update(" ".join(CAPI_FLAGS).encode())
    out = BUILD_DIR / f"example_submit-{h.hexdigest()[:16]}"
    return _compile(out, CAPI_FLAGS, [CAPI / n for n in CAPI_SOURCES],
                    ["-lpthread"])


def _compile(out: Path, flags: list, sources: list, libs: list) -> Path:
    if out.exists():
        return out
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [compiler(), *flags, "-o", str(tmp), *map(str, sources),
             *libs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler()} failed for "
                f"{', '.join(Path(s).name for s in sources)}:\n"
                f"{proc.stdout}")
        os.replace(tmp, out)
    return out
