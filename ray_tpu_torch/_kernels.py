"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` (``flash_fwd.cu``: K1; ``flash_bwd.cu``: K2 and
K3) compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded with ``ctypes``. A library is built at first use into
``_build/`` beside this file, named by a hash of its source, every shared
header (``HEADERS``: ``common.cuh``, what every source uses;
``hopper.cuh``, the Hopper TMA, mbarrier and wgmma helpers;
``mma_sync.cuh``, the ``mma.sync`` ones) and the flags, so an
edited source or header rebuilds and an unchanged one loads at once.
``build()`` starts one ``nvcc`` per source, all together. The libraries
link nothing beyond the CUDA runtime: ``cuTensorMapEncodeTiled`` is
looked up at run time through the runtime's entry-point query, so no
``-lcuda``.

Nothing here runs at import time: the CPU tests import every module, on
hosts that may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# every header under csrc/, by name: each is part of every library's hash
HEADERS = ("common.cuh", "hopper.cuh", "mma_sync.cuh")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes cuts an undeclared pointer to 32 bits, so every entry point has
# its argument types: pointers; dtype, b, h, hk, sq, skv, d; the batch,
# sequence and head strides of each tensor; scale, causal, stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _argtypes(n_ptr: int, n_strided: int) -> list:
    return [_P] * n_ptr + [_I] * 7 + [_LL] * (3 * n_strided) + \
        [ctypes.c_float, _I, _P]


# source name -> {entry point: argtypes}
SOURCES = {
    # q, k, v, out, lse; strides of q, k, v, out
    "flash_fwd": {"rt_flash_fwd": _argtypes(5, 4)},
    # q, k, v, dout, lse, delta, dq (dk, dv); strides of q, k, v, dout,
    # dq (dk, dv)
    "flash_bwd": {"rt_flash_bwd_dq": _argtypes(7, 5),
                  "rt_flash_bwd_dkv": _argtypes(8, 6)},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def source(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    return CSRC / f"{name}.cu"


def lib_path(name: str) -> Path:
    """The library of source ``name``: ``_build/lib<name>-<hash>.so``, the
    hash over the source, every header and the flags."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in HEADERS:
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the libraries of ``names`` (default: every source) that are
    not built yet, one ``nvcc`` per source, all started together, and
    return their paths. Raises with the compiler's output if a build
    fails. Each ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept in ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: lib_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            todo[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {source(name).name}:\n{log}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in SOURCES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            _libs[name] = lib
        return lib


def sass(name: str) -> str:
    """The SASS of source ``name``'s built library (``cuobjdump -sass``,
    from nvcc's toolkit): what the card runs, to count its instructions."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(build([name])[name])],
                          capture_output=True, text=True, check=True).stdout


# hopper.cuh's kTensorMapError: a failed tensor-map encode returns it plus
# cuTensorMapEncodeTiled's CUresult
TENSOR_MAP_ERROR = 1 << 20


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned an error code."""
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what} failed: tensor map encode returned "
                           f"CUresult {err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
